"""The port's ``ContinuousBatcher`` on a mesh engine: 8 gloo ranks, a
``(2, 4)`` ``("data", "model")`` mesh, smoke qwen3-4b, qwen3-moe
(drop-free capacity) and mamba2 in f32, 6 requests over 4 slots with
staggered arrivals.

* greedy: every rank's tokens equal the JAX batcher's on a
  ``ServeEngine`` with a ``(2, 4)`` mesh of 8 host devices (one JAX child
  for the file), on the same weights;
* ``offload=True`` with 4 device pages: requests park on the host tier
  and lease back, and every token is the same; each rank counts the
  bytes of its own blocks;
* at temperature 0.8 the tokens equal the port's one-card batcher's
  (sampling is uid / pos keyed, so the ranks' gathered logits give the
  one card's draws).

The qwen3-4b decode plan shards the slots over ``data`` (two per rank),
so admission and parking go through the ranks that hold each slot."""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

import torch_mesh_ranks
from _torch_parity import one_torch_thread  # noqa: F401 (autouse fixture)
from repro.configs import get_config, smoke_variant
from repro.models.model_zoo import build_model as jax_build_model
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_jax
from repro_torch.core.tree import leaves
from repro_torch.launch.mesh import start
from repro_torch.models.model_zoo import build_model
from repro_torch.serve import ServeEngine

ARCHS = ("qwen3-4b", "qwen3-moe-235b-a22b", "mamba2-2.7b")
MESH = {"data": 2, "model": 4}
SLOTS, MAX_SEQ, TEMPERATURE = 4, 32, 0.8

_CHILD = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses, json
import numpy as np
import jax
from repro import compat
from repro.configs import get_config, smoke_variant
from repro.models.model_zoo import build_model
from repro.serve import ContinuousBatcher, Request, ServeEngine

args = json.loads(sys.argv[1])
mesh = compat.make_mesh((2, 4), ("data", "model"))
out = {}
for arch in args["archs"]:
    cfg = dataclasses.replace(smoke_variant(get_config(arch)), dtype="float32")
    if cfg.is_moe:
        cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.num_experts))
    api = build_model(cfg)
    eng = ServeEngine(api=api, batch_size=args["slots"], max_seq=args["max_seq"], mesh=mesh)
    eng.load(api.init(jax.random.PRNGKey(0)))
    reqs = [Request(uid=u, prompt=np.asarray(p, np.int32), max_new_tokens=n, arrival=a)
            for u, p, n, a in args["spec"]]
    res = ContinuousBatcher(eng, page_size=4).run(reqs)
    out[arch] = {str(u): [int(t) for t in r.tokens] for u, r in res.items()}
print("RESULT " + json.dumps(out))
"""


def _cfgs(arch):
    cfg = dataclasses.replace(smoke_variant(get_config(arch)), dtype="float32")
    tcfg = dataclasses.replace(tconfigs.smoke_variant(tconfigs.get_config(arch)),
                               dtype="float32")
    if cfg.is_moe:
        cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.num_experts))
        tcfg = dataclasses.replace(tcfg, capacity_factor=float(tcfg.num_experts))
    return cfg, tcfg


def _spec(vocab):
    """6 requests: prompts of 3-6 tokens, 2-5 new tokens, arriving in
    pairs a tick apart."""
    rng = np.random.RandomState(3)
    return [(u, rng.randint(0, vocab, size=int(rng.randint(3, 7))).tolist(),
             int(rng.randint(2, 6)), u // 2) for u in range(1, 7)]


@pytest.fixture(scope="module")
def run():
    spec = _spec(_cfgs(ARCHS[0])[1].vocab_size)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", "src")]
        + env.get("PYTHONPATH", "").split(os.pathsep))
    arg = json.dumps({"archs": ARCHS, "slots": SLOTS, "max_seq": MAX_SEQ, "spec": spec})
    child = subprocess.Popen([sys.executable, "-c", _CHILD, arg], env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        jobs, one_card = {}, {}
        for arch in ARCHS:
            cfg, tcfg = _cfgs(arch)
            params = params_from_jax(jax.tree.map(np.asarray, jax_build_model(cfg).init(
                jax.random.PRNGKey(0))), tcfg)
            jobs[arch] = (tcfg, jax.tree.map(lambda t: t.numpy(), params))
            eng = ServeEngine(build_model(tcfg, device="cpu"), batch_size=SLOTS,
                              max_seq=MAX_SEQ, device="cpu")
            eng.load(params)
            one_card[arch] = torch_mesh_ranks.batcher_tokens(
                eng, spec, page_size=4, temperature=TEMPERATURE)[0]
        ranks = start(torch_mesh_ranks.batcher_world, tuple(MESH.values()), tuple(MESH),
                      device="cpu", args=(jobs, spec, SLOTS, MAX_SEQ, TEMPERATURE),
                      timeout_s=400, verbose=False).join()
        stdout, stderr = child.communicate(timeout=600)
        assert child.returncode == 0 and "RESULT " in stdout, stderr[-4000:]
    finally:
        if child.poll() is None:
            child.kill()
    line = next(ln for ln in stdout.splitlines() if ln.startswith("RESULT "))
    ref = {arch: {int(u): t for u, t in toks.items()}
           for arch, toks in json.loads(line[len("RESULT "):]).items()}
    return {"ranks": ranks, "ref": ref, "one_card": one_card, "spec": spec}


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_equal_the_jax_mesh_batcher(run, arch):
    for rank in run["ranks"]:
        assert rank[arch]["greedy"] == run["ref"][arch]
    assert sorted(run["ref"][arch]) == [u for u, *_ in run["spec"]]


@pytest.mark.parametrize("arch", ARCHS)
def test_offload_parking_keeps_the_tokens(run, arch):
    for rank in run["ranks"]:
        assert rank[arch]["page_outs"] > 0
        assert rank[arch]["transfer_bytes"] > 0
        assert rank[arch]["offload"] == rank[arch]["greedy"]


def test_offload_moves_each_ranks_own_blocks(run):
    """A rank moves its block of each parked slot out and back in: with
    qwen3-4b's slots sharded over ``data`` and the other dims whole, a
    whole slot's cache (``cache_init(1, MAX_SEQ)``) each way."""
    tcfg = _cfgs("qwen3-4b")[1]
    one = build_model(tcfg, device="cpu").cache_init(1, MAX_SEQ)
    slot = sum(t.numel() * t.element_size() for t in leaves(one))
    for rank in run["ranks"]:
        got = rank["qwen3-4b"]
        assert got["transfer_bytes"] == 2 * got["page_outs"] * slot


@pytest.mark.parametrize("arch", ARCHS)
def test_sampled_tokens_equal_the_one_card_batcher(run, arch):
    for rank in run["ranks"]:
        assert rank[arch]["sampled"] == run["one_card"][arch]
