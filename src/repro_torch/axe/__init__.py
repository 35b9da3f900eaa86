# The kernel DSL of the port (axe.stages, axe.program), the layout
# algebra's specs (axe.spec), graphs, propagation, solver and compiler
# (axe.graphs, axe.propagate, axe.rules, axe.solve, axe.compile), the
# fusion passes (axe.passes), the on-device tile lowering (axe.lower) and
# the solve <-> tune loop (axe.cotune).


def __getattr__(name):
    # the compiler's consumer-facing entry points, as ``repro.axe``
    # exports them; imported on first use (axe.compile imports the kernel
    # programs, which import axe.program)
    if name in ("compiled_loss_fn", "model_executable"):
        from repro_torch.axe import compile as _compile

        return getattr(_compile, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
