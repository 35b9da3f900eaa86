"""Shared helpers of the ``test_torch_*`` files: inputs drawn once in
numpy from a seed and handed to both the JAX package and the port,
the reference's tolerances, and the fixture that skips card-only tests
on a host without one."""
import os

import numpy as np
import pytest
import torch

from repro_torch.convert import to_numpy, to_torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU ops of a module on one thread (a module that imports
    this fixture). Under several pytest workers a pool of intra-op threads
    in each oversubscribes the cores and spins; one thread each keeps the
    module's time its own. The previous count is restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def draw(seed, shape, dtype="float32", scale=1.0):
    """Standard-normal numpy input; bf16 as ``ml_dtypes.bfloat16`` so JAX
    and torch get the same bits."""
    import ml_dtypes  # JAX's bf16 numpy type; the card's tests need none of it

    x = np.random.default_rng(seed).standard_normal(shape, dtype=np.float32) * scale
    return x.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else x


def tol(dtype):
    """``tests/test_program.py:_tol``: f32 admits accumulation-order
    differences, bf16 one rounding of the output."""
    if dtype in ("bfloat16", torch.bfloat16):
        return dict(rtol=2e-2, atol=2e-2)
    return dict(rtol=1e-3, atol=1e-4)


#: (test id, max |got - want|, rtol, atol) of every assert_close in this
#: process — tests/torch_parity_report.py prints them as PERF.md's table
RECORDS = []


def assert_close(got, want, **kw):
    """Compare a torch tensor or numpy/JAX array against another in f32."""
    as32 = lambda a: (to_numpy(a) if isinstance(a, torch.Tensor) else np.asarray(a)).astype(np.float32)
    got, want = as32(got), as32(want)
    RECORDS.append((os.environ.get("PYTEST_CURRENT_TEST", ""),
                    float(np.max(np.abs(got - want), initial=0.0)), kw.get("rtol"), kw.get("atol")))
    np.testing.assert_allclose(got, want, **kw)


def t(a, device="cpu"):
    return to_torch(a, device)


@pytest.fixture
def cuda():
    """A CUDA device, or a skip: the hand-written kernels have no CPU
    mode, so these tests run only on a machine with a card
    (``pytest -m gpu``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")
