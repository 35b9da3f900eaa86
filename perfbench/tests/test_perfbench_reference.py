"""The plain reference against ``repro_torch`` at smoke width on the CPU
(float32): prefill logits, decode logits from the program's cache, keys and
values, the loss and the gradients, dense and MoE."""
import pytest
import torch

from perfbench.core import compare
from perfbench.core.portcfg import port_config
from perfbench.core.weights import make_params
from perfbench.reference import qwen3, qwen3_moe
from perfbench.tests import smoke


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def model(name):
    from repro_torch.models.model_zoo import build_model

    cell = smoke.cell(name)
    config = cell.config
    params = make_params(config, 2 ** 35 + 1, "cpu", "float32")
    return config, params, build_model(port_config(config), device="cpu")


REFS = {"qwen3-4b.rag": qwen3, "qwen3-moe.chat": qwen3_moe}


@pytest.mark.parametrize("name", list(REFS))
def test_prefill_and_decode_logits(name):
    config, params, api = model(name)
    ref = REFS[name]
    gen = torch.Generator().manual_seed(3)
    prompt = torch.randint(0, config["vocab_size"], (1, 17), generator=gen)
    cache = api.cache_init(1, 32)
    logits, cache = api.prefill(params, {"tokens": prompt}, cache)
    want, kv = ref.sequence(params, config, prompt[0], [16], keep_kv=True)
    torch.testing.assert_close(logits[0, -1], want[0], rtol=1e-4, atol=1e-4)
    for layer, (k, v) in enumerate(kv):
        assert compare.rel_err(cache["l0"]["k"][layer, 0, :17], k) < 1e-5
        assert compare.rel_err(cache["l0"]["v"][layer, 0, :17], v) < 1e-5
    # one decode step of the prefilled slot beside a second slot at another depth
    cache2 = api.cache_init(2, 32)
    cache2["l0"]["k"][:, 0] = cache["l0"]["k"][:, 0]
    cache2["l0"]["v"][:, 0] = cache["l0"]["v"][:, 0]
    tok = torch.tensor([int(logits[0, -1].argmax()), 5], dtype=torch.int32)
    pos = torch.tensor([17, 0], dtype=torch.int32)
    step, cache2 = api.decode_step(params, tok[:, None].long(), cache2, pos)
    got, new_kv = ref.tick(params, config, {"k": cache2["l0"]["k"], "v": cache2["l0"]["v"]},
                           tok, pos)
    torch.testing.assert_close(step[:, -1], got, rtol=1e-4, atol=1e-4)
    for layer, (k, v) in enumerate(new_kv):
        assert compare.rel_err(cache2["l0"]["k"][layer, [0, 1], [17, 0]], k) < 1e-5


def test_moe_capacity_drops_as_the_program():
    # a prompt long enough that the capacity drops assignments in the prefill
    config, params, api = model("qwen3-moe.chat")
    gen = torch.Generator().manual_seed(4)
    prompt = torch.randint(0, config["vocab_size"], (1, 40), generator=gen)
    logits, _ = api.prefill(params, {"tokens": prompt}, api.cache_init(1, 48))
    stats = {}
    want, _ = qwen3_moe.sequence(params, config, prompt[0], [39], stats=stats)
    assert stats["dropped"] > 0
    torch.testing.assert_close(logits[0, -1], want[0], rtol=1e-4, atol=1e-4)


def test_loss_and_grads():
    from repro_torch.train.train_loop import value_and_grad

    config, params, api = model("qwen3-4b.train")
    gen = torch.Generator().manual_seed(5)
    ids = torch.randint(0, config["vocab_size"], (2, 17), generator=gen, dtype=torch.int32)
    batch = {"tokens": ids[:, :-1].contiguous(), "labels": ids[:, 1:].contiguous()}
    loss, grads = value_and_grad(api.loss_fn)(params, batch)
    ref_loss, ref_grads = qwen3.loss_and_grads(params, config, batch["tokens"], batch["labels"],
                                               head_rows=7)
    assert float(loss) == pytest.approx(ref_loss, rel=1e-5)
    for path in qwen3.leaf_paths(params):
        a, b = grads, ref_grads
        for k in path:
            a, b = a[k], b[k]
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-6)


def test_fp8_control_differs():
    config, params, _ = model("qwen3-4b.rag")
    toks = torch.arange(30) % config["vocab_size"]
    exact, _ = qwen3.sequence(params, config, toks, range(30))
    low, _ = qwen3.sequence(params, config, toks, range(30), prec=qwen3.FP8)
    gaps = compare.gaps(exact, low.argmax(-1))
    assert max(gaps) > 0.0
