"""AxeSpec end to end in the port: one layout spec from the device
mesh to the CUDA tile, and the multi-granularity kernel DSL written
against it — the names ``repro.axe`` exports.

* ``repro_torch.axe.spec``      — :class:`AxeSpec` + :class:`PhysicalSpace`
* ``repro_torch.axe.lower``     — the tile lowering (AxeSpec → CUDA grid,
  tile and TMA box); the mesh half waits for ``ROADMAP.md`` A14
* ``repro_torch.axe.propagate`` — layout propagation over op graphs
* ``repro_torch.axe.rules``     — the sharding rule engine
* ``repro_torch.axe.program``   — ``axe.program`` / ``@axe.kernel``:
  kernels as graphs of scope-tagged stages, schedules keyed
  ``program_name/stage_name`` through ``repro_torch.tune``
* ``repro_torch.axe.stages``    — the :class:`Stage` unit + scope validation
* ``repro_torch.axe.graphs``, ``solve``, ``cotune``, ``hetero`` — the
  graphs, the layout solver, the solve <-> tune loop, device classes
* ``repro_torch.axe.compile``   — ``axe.compile``: GraphSpec + LayoutPlan
  → an :class:`Executable` whose ops bind to the kernel programs
* ``repro_torch.axe.passes``    — the fusion passes run before solve/compile

As in the JAX package, the attributes ``program``, ``propagate``,
``solve``, ``cotune`` and ``compile`` are the functions, not the
submodules (reach those with ``importlib.import_module``). The mesh
adapters (:data:`MESH_ONLY`) raise, naming ``ROADMAP.md`` A14.
"""
from repro_torch.axe.spec import AxeSpec, PhysicalSpace, SpecError
from repro_torch.axe.program import (
    PROGRAMS,
    Epilogue,
    Program,
    ProgramError,
    StageContext,
    get_program,
    kernel,
    program,
)
from repro_torch.axe.stages import Stage, StageError
from repro_torch.axe.lower import BlockLowering, block_lowering, spec_of_block, to_blockspec
from repro_torch.axe.propagate import (
    LayoutPlan,
    OpNode,
    PlanEntry,
    PropagationError,
    Redistribution,
    propagate,
    propagate_matmul,
    redistribute,
)
from repro_torch.axe.graphs import (
    GraphSpec,
    TensorMeta,
    cache_window,
    decode_graph,
    decoder_layer_graph,
    model_graph,
)
from repro_torch.axe.hetero import (
    ClassTable,
    DeviceClass,
    HeteroError,
    class_table,
    default_class_table,
    parse_classes,
    use_class_table,
)
from repro_torch.axe.solve import Decision, SolveError, SolveResult, enumerate_specs, solve
from repro_torch.axe.cotune import CotuneIteration, CotuneResult, cotune
from repro_torch.axe.passes import (
    DeadCodeElimination,
    EpilogueFusion,
    FusionReport,
    Pass,
    PassError,
    PassPipeline,
    PassReport,
    Pattern,
    ReshapePairCollapse,
    default_pipeline,
    fuse_graph,
)
from repro_torch.axe.compile import (
    CompileError,
    Executable,
    LoweredOp,
    compile,
    compiled_loss_fn,
    decode_cache,
    decode_executable,
    decode_inputs,
    model_executable,
    model_inputs,
    op_backend,
    plan_covers,
    register_op_backend,
)

#: the JAX package's AxeSpec <-> PartitionSpec / NamedSharding adapters
#: (``repro/axe/lower.py``): they need a device mesh
MESH_ONLY = ("from_pspec", "from_sharding", "layout_of_pspec", "pspec_of_layout",
             "to_named_sharding", "to_pspec")

__all__ = [
    "AxeSpec", "BlockLowering", "ClassTable", "CompileError", "CotuneIteration",
    "CotuneResult", "DeadCodeElimination", "Decision", "DeviceClass", "Epilogue",
    "EpilogueFusion", "Executable", "FusionReport", "GraphSpec", "HeteroError", "LoweredOp",
    "LayoutPlan", "OpNode", "PROGRAMS", "Pass", "PassError", "PassPipeline", "PassReport",
    "Pattern", "PhysicalSpace", "PlanEntry", "Program", "ProgramError", "PropagationError",
    "Redistribution", "ReshapePairCollapse", "SolveError", "SolveResult", "SpecError", "Stage",
    "StageContext", "StageError", "TensorMeta", "block_lowering", "cache_window", "class_table",
    "compile", "compiled_loss_fn", "cotune", "default_class_table", "decode_cache",
    "decode_executable", "decode_graph", "decode_inputs", "decoder_layer_graph",
    "default_pipeline", "enumerate_specs", "fuse_graph", "get_program", "kernel",
    "model_executable", "model_graph", "model_inputs", "op_backend", "parse_classes",
    "plan_covers", "program", "register_op_backend", "solve", "use_class_table", "propagate",
    "propagate_matmul", "redistribute", "spec_of_block", "to_blockspec",
]


def __getattr__(name):
    if name in MESH_ONLY:
        raise NotImplementedError(
            f"repro_torch.axe.{name} lowers an AxeSpec onto a device mesh: the multi-GPU "
            f"slice, ROADMAP.md A14")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
