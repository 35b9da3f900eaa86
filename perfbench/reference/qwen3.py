"""Plain PyTorch reference of the Qwen3 decoder (Hugging Face
``Qwen3ForCausalLM``), the yardstick that decides ``correct``.

It reads the weights the benchmark made (the same tensors the program
serves) and computes in float32 with TF32 off, layer by layer, so it fits
beside the program's cache on one card. It imports nothing of the program.

The layer: RMSNorm, GQA attention with a per-head RMSNorm of q and k
before rotary embedding on split halves (theta from the config), SwiGLU
MLP (``qwen3_moe`` swaps in its expert layer), a final RMSNorm and the
head (the embedding, transposed, where the config ties them).

``Precision`` decides how the operands of every linear product are
rounded: ``EXACT`` (float32) for the reference, ``FP8`` (e4m3, a scale
per row of activations and per output column of weights) for the control
that stands in the program's place one precision below its bfloat16.

Entry points:

- :func:`sequence` — one sequence, causal, all positions: the logits at
  the positions asked for, and each layer's keys and values (post-rope)
  where asked for. The teacher-forced check.
- :func:`tick` — one decode step over a batch of slots from a KV cache
  laid out as the program keeps it (``[layer, slot, position, kv head,
  head dim]``, keys post-rope): the positions before each slot's own are
  read from that cache, the slot's own key and value are the reference's.
- :func:`train_steps` — loss, gradients (float32) and AdamW, step by
  step, layer by layer with the layer inputs kept and each layer
  recomputed in the backward.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

#: largest finite value of float8 e4m3
E4M3_MAX = 448.0


def exact_mode() -> None:
    """float32 products in full float32 (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to e4m3 with one absmax scale per slice along ``dim``,
    back in float32; straight through for autograd."""
    scale = x.detach().abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / E4M3_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return x + (q - x.detach())


@dataclasses.dataclass(frozen=True)
class Precision:
    name: str
    fp8: bool

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``x [..., K] @ w [K, N]`` in float32 (``w`` upcast here)."""
        w = w.float()
        if self.fp8:
            x, w = _fp8(x, -1), _fp8(w, 0)
        return x @ w


EXACT = Precision("float32", False)
FP8 = Precision("fp8_e4m3", True)


@dataclasses.dataclass(frozen=True)
class Dims:
    """The sizes the reference needs, read from the configuration file
    (Hugging Face keys)."""

    layers: int
    d: int
    heads: int
    kv_heads: int
    head_dim: int
    vocab: int
    eps: float
    theta: float
    tied: bool

    @classmethod
    def of(cls, config: Dict[str, Any]) -> "Dims":
        return cls(layers=config["num_hidden_layers"], d=config["hidden_size"],
                   heads=config["num_attention_heads"], kv_heads=config["num_key_value_heads"],
                   head_dim=config["head_dim"], vocab=config["vocab_size"],
                   eps=config["rms_norm_eps"], theta=float(config["rope_theta"]),
                   tied=bool(config["tie_word_embeddings"]))


def rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    x = x.float()
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w.float()


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """``x [..., T, H, hd]`` rotated at positions ``pos [..., T]`` (halves)."""
    half = x.shape[-1] // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float64, device=x.device) / half)
    ang = (pos.double()[..., None] * inv).float()[..., None, :]
    cos, sin = ang.cos(), ang.sin()
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def layer_params(params: Dict[str, Any], layer: int) -> Dict[str, Any]:
    """Layer ``layer``'s leaves (views of the stacked ones)."""
    def take(tree):
        return {k: take(v) if isinstance(v, dict) else v[layer] for k, v in tree.items()}
    return take(params["blocks"]["l0"])


def head_weight(params: Dict[str, Any], dims: Dims) -> torch.Tensor:
    return params["embed"].t() if dims.tied else params["lm_head"]


def swiglu(p: Dict[str, Any], h: torch.Tensor, prec: Precision, _stats=None) -> torch.Tensor:
    m = p["mlp"]
    return prec.mm(F.silu(prec.mm(h, m["wg"])) * prec.mm(h, m["wu"]), m["wo"])


def qkv(p: Dict[str, Any], h: torch.Tensor, pos: torch.Tensor, dims: Dims, prec: Precision):
    """``h [..., T, d]`` at ``pos [..., T]`` -> q ``[..., T, H, hd]``, k, v
    ``[..., T, KV, hd]`` (k post-norm, post-rope)."""
    a, lead = p["attn"], h.shape[:-1]
    q = prec.mm(h, a["wq"]).view(*lead, dims.heads, dims.head_dim)
    k = prec.mm(h, a["wk"]).view(*lead, dims.kv_heads, dims.head_dim)
    v = prec.mm(h, a["wv"]).view(*lead, dims.kv_heads, dims.head_dim)
    q = rope(rms(q, a["q_norm"], dims.eps), pos, dims.theta)
    k = rope(rms(k, a["k_norm"], dims.eps), pos, dims.theta)
    return q, k, v


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     block: int = 512) -> torch.Tensor:
    """``q [T, H, hd]`` over ``k, v [T, KV, hd]``, causal, in query blocks:
    ``[T, H·hd]``."""
    t, h, hd = q.shape
    g = h // k.shape[1]
    kk = k.repeat_interleave(g, dim=1).transpose(0, 1)        # [H, T, hd]
    vv = v.repeat_interleave(g, dim=1).transpose(0, 1)
    out = []
    for s in range(0, t, block):
        e = min(t, s + block)
        sc = torch.einsum("qhd,hkd->hqk", q[s:e], kk[:, :e]) / hd ** 0.5
        keys, rows = torch.arange(e, device=q.device), torch.arange(s, e, device=q.device)
        mask = keys[None, :] > rows[:, None]
        sc = sc.masked_fill(mask, float("-inf"))
        out.append(torch.einsum("hqk,hkd->qhd", sc.softmax(-1), vv[:, :e]))
    return torch.cat(out).reshape(t, h * hd)


Ffn = Callable[..., torch.Tensor]


def _layer(p, x, pos, dims, prec, ffn: Ffn, stats, attend):
    h = rms(x, p["norm1"], dims.eps)
    q, k, v = qkv(p, h, pos, dims, prec)
    x = x + prec.mm(attend(q, k, v), p["attn"]["wo"])
    return x + ffn(p, rms(x, p["norm2"], dims.eps), prec, stats), k, v


def sequence(params, config, tokens: torch.Tensor, want: Sequence[int], *,
             prec: Precision = EXACT, ffn: Ffn = swiglu, keep_kv: bool = False,
             stats: Optional[Dict[str, int]] = None):
    """One sequence ``tokens [T]`` through the model as one causal call.
    Returns the float32 logits ``[len(want), V]`` at positions ``want`` and,
    with ``keep_kv``, each layer's keys and values ``[T, KV, hd]``."""
    dims = Dims.of(config)
    t = tokens.shape[0]
    pos = torch.arange(t, device=tokens.device)
    x = params["embed"][tokens.long()].float()
    kv: List[tuple] = []
    for layer in range(dims.layers):
        x, k, v = _layer(layer_params(params, layer), x, pos, dims, prec, ffn, stats,
                         causal_attention)
        if keep_kv:
            kv.append((k, v))
    idx = torch.as_tensor(list(want), device=x.device, dtype=torch.long)
    x = rms(x[idx], params["final_norm"], dims.eps)
    return prec.mm(x, head_weight(params, dims)), kv


def tick(params, config, cache: Dict[str, torch.Tensor], tok: torch.Tensor, pos: torch.Tensor,
         *, prec: Precision = EXACT, ffn: Ffn = swiglu, stats: Optional[Dict[str, int]] = None):
    """One decode step of every slot: ``tok [B]`` at ``pos [B]`` over
    ``cache["k"], cache["v"]`` ``[L, B, W, KV, hd]`` (positions below each
    slot's ``pos`` are read; the slot's own key and value are computed
    here). Returns the float32 logits ``[B, V]`` and each layer's new keys
    and values ``[B, KV, hd]``."""
    dims = Dims.of(config)
    b = tok.shape[0]
    span = int(pos.max()) + 1
    live = torch.arange(span, device=tok.device)[None, :] <= pos[:, None].long()  # [B, span]
    rows = torch.arange(b, device=tok.device)
    g = dims.heads // dims.kv_heads
    new_kv: List[tuple] = []

    def attend_layer(layer):
        def attend(q, k, v):
            keys = _f32(cache["k"][layer, :, :span])
            vals = _f32(cache["v"][layer, :, :span])
            keys[rows, pos.long()] = k
            vals[rows, pos.long()] = v
            new_kv.append((k, v))
            qg = q.view(b, dims.kv_heads, g, dims.head_dim)
            sc = torch.einsum("bkgd,bskd->bkgs", qg, keys) / dims.head_dim ** 0.5
            sc = sc.masked_fill(~live[:, None, None, :], float("-inf"))
            out = torch.einsum("bkgs,bskd->bkgd", sc.softmax(-1), vals)
            return out.reshape(b, dims.heads * dims.head_dim)
        return attend

    x = params["embed"][tok.long()].float()
    for layer in range(dims.layers):
        x, _, _ = _layer(layer_params(params, layer), x, pos.long(), dims, prec, ffn, stats,
                         attend_layer(layer))
    x = rms(x, params["final_norm"], dims.eps)
    return prec.mm(x, head_weight(params, dims)), new_kv


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AdamW:
    """AdamW as the configuration states it (decoupled weight decay on
    every leaf, bias-corrected moments in float32), after a clip of the
    global gradient norm."""

    lr: float
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    max_grad_norm: float = 1.0


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def leaf_paths(tree, prefix=()) -> List[tuple]:
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in leaf_paths(tree[k], prefix + (k,))]
    return [prefix]


def _batch_attention(q, k, v):
    """``q [B, T, H, hd]`` causal over ``k, v [B, T, KV, hd]``, row by row."""
    return torch.stack([causal_attention(q[i], k[i], v[i], block=q.shape[1])
                        for i in range(q.shape[0])])


def _train_layer(p, x, pos, dims, prec):
    return _layer(p, x, pos, dims, prec, swiglu, None, _batch_attention)[0]


def loss_and_grads(params, config, tokens: torch.Tensor, labels: torch.Tensor, *,
                   prec: Precision = EXACT, head_rows: int = 1024):
    """Mean token cross entropy of ``tokens, labels [B, T]`` and the float32
    gradient of every leaf (a tree like ``params``). The layer inputs are
    kept; each layer is recomputed in the backward."""
    dims = Dims.of(config)
    b, t = tokens.shape
    pos = torch.arange(t, device=tokens.device).expand(b, t)
    grads = {"blocks": {"l0": _zeros_like_f32(params["blocks"]["l0"])},
             "embed": torch.zeros(params["embed"].shape, device=tokens.device),
             "final_norm": torch.zeros(params["final_norm"].shape, device=tokens.device)}
    if not dims.tied:
        grads["lm_head"] = torch.zeros(params["lm_head"].shape, device=tokens.device)
    with torch.no_grad():
        x = params["embed"][tokens.long()].float()
        inputs = []
        for layer in range(dims.layers):
            inputs.append(x)
            x = _train_layer(layer_params(params, layer), x, pos, dims, prec)
    # the head, row block by row block
    n = b * t
    xf = x.reshape(n, dims.d).detach().requires_grad_()
    wn = _f32(params["final_norm"]).requires_grad_()
    with torch.enable_grad():
        h = rms(xf, wn, dims.eps)
    w = _f32(head_weight(params, dims)).requires_grad_()
    dh = torch.empty_like(h)
    dw = torch.zeros_like(w)
    flat = labels.reshape(n).long()
    loss = torch.zeros((), device=tokens.device, dtype=torch.float64)
    for s in range(0, n, head_rows):
        e = min(n, s + head_rows)
        with torch.enable_grad():
            hc = h.detach()[s:e].requires_grad_()
            logits = prec.mm(hc, w)
            part = (torch.logsumexp(logits, -1) - logits.gather(1, flat[s:e, None])[:, 0]).sum()
            ghc, gw = torch.autograd.grad(part / n, [hc, w])
        loss += part.detach().double()
        dh[s:e] = ghc
        dw += gw
        del logits, part, ghc, gw
    dxf, dwn = torch.autograd.grad(h, [xf, wn], dh)
    grads["final_norm"] += dwn
    if dims.tied:
        grads["embed"] += dw.t()
    else:
        grads["lm_head"] += dw
    dx = dxf.view(b, t, dims.d)
    for layer in reversed(range(dims.layers)):
        p = layer_params(params, layer)
        p32 = _f32_leaves(p)
        xin = inputs[layer].requires_grad_()
        with torch.enable_grad():
            out = _train_layer(p32, xin, pos, dims, prec)
            ps = _leaves(p32)
            got = torch.autograd.grad(out, [xin] + ps, dx)
        dx = got[0]
        for gslot, gval in zip(_leaves(_layer_view(grads["blocks"]["l0"], layer)), got[1:]):
            gslot += gval
        inputs[layer] = None
    grads["embed"].index_add_(0, tokens.reshape(-1).long(), dx.reshape(n, dims.d))
    return float(loss / n), grads


def _zeros_like_f32(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like_f32(v) for k, v in tree.items()}
    return torch.zeros(tree.shape, device=tree.device)


def _f32_leaves(tree):
    if isinstance(tree, dict):
        return {k: _f32_leaves(v) for k, v in tree.items()}
    return _f32(tree).requires_grad_()


def _layer_view(tree, layer):
    if isinstance(tree, dict):
        return {k: _layer_view(v, layer) for k, v in tree.items()}
    return tree[layer]


def adamw_step(params, grads, mu, nu, count: int, opt: AdamW, at=None):
    """Clip by the global norm, then one AdamW step in float32 on every
    leaf; params keep their type. The gradients are clipped in place;
    returns each leaf's clipped norm (``leaf_paths`` order) and, where
    ``at`` gives each leaf's flat indices, its clipped elements there."""
    gl = _leaves(grads)
    norm = torch.sqrt(sum(g.double().square().sum() for g in gl)).float()
    scale = torch.clamp(opt.max_grad_norm / (norm + 1e-9), max=1.0)
    bc1, bc2 = 1.0 - opt.b1 ** count, 1.0 - opt.b2 ** count
    norms, picked = [], []
    for i, (p, g, m, v) in enumerate(zip(_leaves(params), gl, _leaves(mu), _leaves(nu))):
        g = g.mul_(scale)
        norms.append(float(g.double().norm()))
        if at is not None:
            picked.append(g.reshape(-1)[at[i]].clone())
        m.mul_(opt.b1).add_(g, alpha=1 - opt.b1)
        v.mul_(opt.b2).add_(g * g, alpha=1 - opt.b2)
        upd = (m / bc1) / (torch.sqrt(v / bc2) + opt.eps) + opt.weight_decay * p.float()
        p.copy_((p.float() - opt.lr * upd).to(p.dtype))
    return norms, picked


def train_steps(params, config, batches: Sequence[Dict[str, torch.Tensor]], opt: AdamW, *,
                prec: Precision = EXACT, at=None):
    """Follow ``len(batches)`` steps from ``params`` (updated in place).
    Returns each step's loss, the first step's clipped gradient's norm leaf
    by leaf (``leaf_paths`` order) and, where ``at`` gives each leaf's flat
    indices, its elements there."""
    mu = _zeros_like_f32(params)
    nu = _zeros_like_f32(params)
    losses, first, first_at = [], None, None
    for i, batch in enumerate(batches):
        loss, grads = loss_and_grads(params, config, batch["tokens"], batch["labels"], prec=prec)
        norms, picked = adamw_step(params, grads, mu, nu, i + 1, opt, at if i == 0 else None)
        if first is None:
            first, first_at = norms, picked
        losses.append(loss)
        del grads
    return losses, first, first_at


#: every position of a sequence is computed alike whatever shares its batch
BATCH_INVARIANT = True


def _f32(t: torch.Tensor) -> torch.Tensor:
    """A float32 copy that never aliases ``t`` (so marking it for autograd
    leaves the weights alone)."""
    return t.detach().to(torch.float32, copy=True)
