"""The port's kernel DSL (``repro_torch.axe.program``): scope laws,
stage validation, the dispatch table, pinned-vs-default schedule
resolution and the device rule — the cases of ``tests/test_scopes.py``
and ``tests/test_program.py:171-215`` held against the port."""
import threading

import pytest
import torch

from repro_torch.axe.program import (
    PROGRAMS,
    DeviceError,
    ProgramError,
    get_program,
    program,
    require_host,
)
from repro_torch.axe.stages import StageError
from repro_torch.core.device import resolve_device
from repro_torch.core.scopes import Scope, current_scope, scope
from repro_torch.kernels import programs
from repro_torch.tune import schedule as tsched

ORDER = [Scope.MESH, Scope.DEVICE, Scope.GRID, Scope.BLOCK]


# ---------------------------------------------------------------------------
# scopes
# ---------------------------------------------------------------------------

def test_scope_ordering_laws():
    for i, s in enumerate(ORDER):
        assert s.rank == i
        for other in ORDER:
            assert s.finer_than(other) == (s.rank > other.rank)
            assert other.can_enter(s) == (other.rank >= s.rank)
    assert current_scope() == Scope.MESH


@pytest.mark.parametrize("outer,inner", [(Scope.BLOCK, Scope.GRID), (Scope.GRID, Scope.DEVICE),
                                         (Scope.DEVICE, Scope.MESH)])
def test_illegal_outward_nesting_raises(outer, inner):
    with scope(outer):
        with pytest.raises(ValueError, match="cannot open"):
            with scope(inner):
                pass
        assert current_scope() == outer
    assert current_scope() == Scope.MESH


def test_scope_stack_is_thread_local():
    inside, release, seen = threading.Event(), threading.Event(), {}

    def worker():
        with scope(Scope.BLOCK):
            inside.set()
            release.wait(timeout=10)
            seen["worker"] = current_scope()

    th = threading.Thread(target=worker)
    th.start()
    assert inside.wait(timeout=10)
    assert current_scope() == Scope.MESH
    release.set()
    th.join(timeout=10)
    assert not th.is_alive() and seen["worker"] == Scope.BLOCK


# ---------------------------------------------------------------------------
# programs: registry, stage validation, dispatch
# ---------------------------------------------------------------------------

def test_programs_registered():
    for prog in programs.ALL_PROGRAMS:
        assert PROGRAMS[prog.name] is prog and get_program(prog.name) is prog
    with pytest.raises(ProgramError, match="no program named"):
        get_program("nonexistent")


def test_stage_scope_validation():
    a = torch.zeros(16, 16)
    with scope(Scope.BLOCK):
        with pytest.raises(StageError, match="cannot be entered"):
            programs.matmul(a, a, stage="tile")
        with pytest.raises(StageError, match="cannot be entered"):
            programs.flash_attention(torch.zeros(1, 1, 4, 64), *(torch.zeros(1, 1, 4, 64),) * 2)
    assert current_scope() == Scope.MESH


def test_unknown_stage_raises():
    a = torch.zeros(16, 16)
    with pytest.raises(ProgramError, match="no stage"):
        programs.matmul(a, a, stage="warp_specialize")


def test_dispatch_table_picks_stage_by_scope():
    # MESH takes the kernel stage until MESH lowering is ported (the JAX
    # package sends it to an XLA dot)
    assert programs.matmul.dispatch_stage(Scope.MESH) == "tile"
    assert programs.matmul.dispatch_stage(Scope.DEVICE) == "tile"
    assert programs.matmul.dispatch_stage(Scope.GRID) == "tile"
    assert programs.matmul.dispatch_stage(Scope.BLOCK) == "dot"
    assert programs.rmsnorm.dispatch_stage(Scope.BLOCK) == "normalize"
    assert programs.rmsnorm.dispatch_stage(Scope.DEVICE) == "rows"
    assert programs.flash_attention.dispatch_stage(Scope.DEVICE) == "attend"
    for scope_ in (Scope.MESH, Scope.DEVICE, Scope.GRID):
        assert programs.moe_gemm.dispatch_stage(scope_) == "expert_gemm"
    assert programs.moe_gemm.dispatch_stage(Scope.BLOCK) == "einsum"


def test_block_stage_usable_directly():
    a = torch.ones(8, 8)
    with scope(Scope.BLOCK):
        out = programs.matmul(a, a)
    torch.testing.assert_close(out, a @ a)


def test_program_describe_lists_stage_keys():
    text = programs.matmul.describe()
    assert "matmul/tile" in text and "matmul/dot" in text
    assert "variants kernel|xla" in text
    assert "flash_attention/decode" in programs.flash_attention.describe()


# ---------------------------------------------------------------------------
# schedules: stage registry, pinned vs declared default
# ---------------------------------------------------------------------------

def test_stage_ops_registered_with_schedule_registry():
    assert tsched.STAGE_IMPLS["matmul/tile"] == ("kernel", "xla")
    assert tsched.allowed_impls("rmsnorm/rows") == ("kernel", "xla")
    assert tsched.allowed_impls("flash_attention/attend") == ("kernel",)
    d = tsched.default_schedule("matmul/tile")
    assert d.impl == "kernel" and d.block("bm") == 128 and d.block("bk") == 64
    assert tsched.allowed_impls("moe_gemm/expert_gemm") == ("kernel", "xla")
    d = tsched.default_schedule("moe_gemm/expert_gemm")
    # the declared tile of B5's wgmma route (64 capacity rows x 128 columns x 64 deep)
    assert d.impl == "kernel" and d.blocks_dict == {"bc": 64, "bf": 128, "bd": 64}
    with pytest.raises(tsched.InvalidImplError):
        tsched.Schedule("flash_attention/attend", "xla")


def test_schedule_describe_parse_round_trip():
    s = tsched.Schedule.parse("kernel:bm=64,bn=128,bk=32", op="matmul/tile")
    assert s.blocks == (("bk", 32), ("bm", 64), ("bn", 128))
    assert tsched.Schedule.parse(s.describe(), op="matmul/tile") == s
    with pytest.raises(ValueError, match="bad schedule spec"):
        tsched.Schedule.parse("kernel:bm=x", op="matmul/tile")


def _probe_program(name):
    """A program whose GRID stage reports how its schedule resolved."""
    prog = program(name)

    @prog.stage("body", scope=Scope.GRID, entry=True, blocks=(("bt", 32), ("bu", 4)),
                variants=("kernel", "xla"))
    def _body(ctx, x):
        return ctx.schedule, ctx.pinned, ctx.block("bt"), ctx.block("bu")

    @prog.stage("inner", scope=Scope.GRID)
    def _inner(ctx, x):
        return ctx.run("body", x)

    return prog


def test_unpinned_stage_resolves_declared_default():
    prog = _probe_program("test_torch_probe_default")
    sched, pinned, bt, bu = prog(torch.zeros(2))
    assert sched == tsched.default_schedule("test_torch_probe_default/body")
    assert not pinned and (bt, bu) == (32, 4)


@pytest.mark.parametrize(
    "kw,want_impl,want_bt,want_bu",
    [
        ({"schedule": "xla"}, "xla", 32, 4),
        ({"schedule": "kernel:bt=64,bu=8"}, "kernel", 64, 8),
        ({"blocks": {"bt": 16}}, "kernel", 16, 4),          # other blocks keep defaults
        ({"impl": "xla"}, "xla", 32, 4),
        ({"schedules": {"body": "kernel:bt=128"}}, "kernel", 128, 4),
    ],
)
def test_pinned_schedules(kw, want_impl, want_bt, want_bu):
    prog = _probe_program("test_torch_probe_pinned")
    sched, pinned, bt, bu = prog(torch.zeros(2), **kw)
    assert pinned and sched.impl == want_impl and (bt, bu) == (want_bt, want_bu)


def test_entry_pins_do_not_cascade_but_schedules_do():
    prog = _probe_program("test_torch_probe_cascade")
    sched, pinned, _, _ = prog(torch.zeros(2), stage="inner", blocks={"bt": 8})
    assert not pinned and sched.block("bt") == 32
    sched, pinned, _, _ = prog(torch.zeros(2), stage="inner", schedules={"body": "xla"})
    assert pinned and sched.impl == "xla"


# ---------------------------------------------------------------------------
# the device rule
# ---------------------------------------------------------------------------

def test_cpu_tensors_run_the_plain_body_without_launching():
    programs.reset_launch_counts()
    a = torch.randn(8, 8)
    torch.testing.assert_close(programs.matmul(a, a), a @ a)
    x, w = torch.randn(2, 8, 16), torch.randn(2, 16, 24)
    # a pin reaches the plain body, which ignores it
    torch.testing.assert_close(programs.moe_gemm(x, w, blocks={"bc": 16}), torch.bmm(x, w))
    assert set(programs.launch_counts().values()) == {0}


class _CardTensor(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA one."""

    is_cuda = True


def test_plain_bodies_refuse_cuda_tensors(monkeypatch):
    """The plain attention bodies run only on CPU tensors. Where the JAX
    package itself falls back to a plain ``jnp`` body (the ``xla``
    variants of B1, B2 and B5, B1's operands that are not 2-D), CUDA
    tensors reach the library's call instead of the plain body."""
    require_host("probe", torch.zeros(2))
    card = torch.zeros(8, 8).as_subclass(_CardTensor)
    with pytest.raises(DeviceError, match="only on CPU tensors"):
        require_host("probe", card)
    card4 = torch.zeros(1, 2, 8, 64).as_subclass(_CardTensor)
    with pytest.raises(DeviceError, match="only on CPU tensors"):
        programs.flash_attention(card4, card4, card4, stage="softmax_mac")
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import moe_gemm as moe_k
    from repro_torch.kernels import rmsnorm as rn

    calls = []
    for mod, name in ((mm, "matmul_library"), (moe_k, "moe_gemm_library"),
                      (rn, "rmsnorm_library")):
        monkeypatch.setattr(mod, name, lambda *a, _n=name, **k: calls.append(_n) or a[0])
    programs.matmul(card, card, impl="xla")
    programs.matmul(torch.zeros(2, 8, 8).as_subclass(_CardTensor), card)
    card3 = torch.zeros(2, 8, 8).as_subclass(_CardTensor)
    programs.moe_gemm(card3, card3, impl="xla")
    programs.rmsnorm(card, torch.ones(8).as_subclass(_CardTensor), impl="xla")
    assert calls == ["matmul_library", "matmul_library", "moe_gemm_library", "rmsnorm_library"]
    assert set(programs.launch_counts().values()) == {0}


def test_entry_points_default_to_cuda_and_never_fall_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")
