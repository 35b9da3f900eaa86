"""The smoke jamba (hybrid: SSD, attention and MoE layers) through
``prefill`` / ``decode_step`` per slot against the JAX package, in f32
and bf16: ``tests/test_torch_ssm.py``'s
``test_prefill_and_per_slot_decode_match_jax`` for jamba, whose body and
tolerances it shares (``check_prefill_and_per_slot_decode``). The two
cases live in a file of their own so that each file stays small enough
to run beside ``tests/test_overlap.py`` under ``--dist loadfile``."""
import pytest

from _torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)
from test_torch_ssm import ARCHS, check_prefill_and_per_slot_decode


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS[1:])
def test_prefill_and_per_slot_decode_match_jax(arch, dtype, monkeypatch):
    """Prefill (logits and every cache leaf, SSD states included), then a
    decode step with the slots at different depths (slot 0 advanced
    alone first), each slot matching its own batch-1 JAX step.

    jamba's MoE top-2 choice can flip in bf16 where two experts' router
    probabilities lie within the two packages' rounding difference, and a
    flipped expert moves that token by far more than rounding (the rule
    ``chip_smoke.py`` holds card and CPU to, ``ROADMAP.md`` §C). So in
    bf16 the port is also run routed as the JAX package routed (JAX's
    choices recorded with its jit off): that run must hold the
    tolerance, and the freely routed one too unless a choice differed."""
    check_prefill_and_per_slot_decode(arch, dtype, monkeypatch)
