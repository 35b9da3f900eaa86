"""Mamba2 SSD (state-space duality) block — the port of
``repro/models/ssm.py``: the chunked form for prefill and the O(1)-state
recurrent step for decode.

Recurrence per head h (state S ∈ R^{N×P}, N = d_state, P = headdim):
    S_t = exp(dt_t A_h) S_{t-1} + dt_t B_t ⊗ x_t
    y_t = C_t · S_t + D_h x_t

The projections run through kernel B1 (``common.linear``) and the gated
norm through kernel B2; the causal conv, the chunked scan and the state
math are plain torch in f32, as the JAX package computes them outside
any Pallas kernel. The JAX package's ``lax.scan`` over chunks becomes a
Python loop; its two intra-chunk products stay ``torch.einsum``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import Params, dense_init, keep_as_is, linear, rmsnorm

CONV_K = 4  # depthwise causal conv width


def ssd_init(gen: torch.Generator, cfg, dtype, lead=(), keep=keep_as_is) -> Params:
    """The mixer's weights, the JAX package's leaves and dtypes
    (``dt_bias``, ``A_log`` and ``D`` in f32); ``lead`` prepends stacking
    dims (super-blocks); ``keep(name, leaf)`` takes each leaf as it is
    drawn."""
    d, di, n, h = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads
    dev = gen.device
    a = torch.rand((*lead, h), generator=gen, device=dev, dtype=torch.float32) * 15.0 + 1.0
    conv = torch.randn((*lead, CONV_K, di + 2 * n), generator=gen, device=dev,
                       dtype=torch.float32) * 0.2
    return {
        "wx": keep("wx", dense_init(gen, (*lead, d, di), d, dtype)),
        "wz": keep("wz", dense_init(gen, (*lead, d, di), d, dtype)),
        "wB": keep("wB", dense_init(gen, (*lead, d, n), d, dtype)),
        "wC": keep("wC", dense_init(gen, (*lead, d, n), d, dtype)),
        "wdt": keep("wdt", dense_init(gen, (*lead, d, h), d, dtype)),
        # softplus(-4) ~0.018
        "dt_bias": keep("dt_bias", torch.full((*lead, h), -4.0, dtype=torch.float32, device=dev)),
        "A_log": keep("A_log", torch.log(a)),
        "D": keep("D", torch.ones((*lead, h), dtype=torch.float32, device=dev)),
        "conv_w": keep("conv_w", conv.to(dtype)),
        "gate_norm": keep("gate_norm", torch.ones((*lead, di), dtype=dtype, device=dev)),
        "wo": keep("wo", dense_init(gen, (*lead, di, d), di, dtype)),
    }


def _causal_conv(u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv by shifted adds, in ``u``'s type as the
    JAX package's. u [B, S, C], w [K, C]."""
    out = u * w[-1]
    for i in range(1, CONV_K):
        shifted = F.pad(u, (0, 0, i, 0))[:, : u.shape[1]]
        out = out + shifted * w[CONV_K - 1 - i]
    return out


def _inputs(p: Params, xin: torch.Tensor, cfg):
    """Project the input to (x [B,S,H,P], z, B, C, dt [B,S,H] f32) with
    the conv and activations."""
    b, s, _ = xin.shape
    di, n = cfg.ssm_d_inner, cfg.ssm_state
    x, z = linear(xin, p["wx"]), linear(xin, p["wz"])
    bm, cm = linear(xin, p["wB"]), linear(xin, p["wC"])
    u = F.silu(_causal_conv(torch.cat([x, bm, cm], dim=-1), p["conv_w"]))
    x, bm, cm = u[..., :di], u[..., di: di + n], u[..., di + n:]
    dt = F.softplus(linear(xin, p["wdt"]).float() + p["dt_bias"])
    return x.reshape(b, s, cfg.ssm_heads, cfg.ssm_headdim), z, bm, cm, dt


def ssd_scan(
    x: torch.Tensor,    # [B, S, H, P]
    dt: torch.Tensor,   # [B, S, H] (f32)
    A: torch.Tensor,    # [H] (negative, f32)
    Bm: torch.Tensor,   # [B, S, N]
    Cm: torch.Tensor,   # [B, S, N]
    *,
    chunk: int = 128,
    init_state: Optional[torch.Tensor] = None,  # [B, H, N, P]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan. Returns (y [B, S, H, P] f32, final state). The
    chunk halves until it divides ``S``, as in the JAX package."""
    b, s, h, pdim = x.shape
    n = Bm.shape[-1]
    chunk = min(chunk, s)
    while s % chunk:
        chunk //= 2
    nc = s // chunk
    xf = x.float().reshape(b, nc, chunk, h, pdim)
    bf = Bm.float().reshape(b, nc, chunk, n)
    cf = Cm.float().reshape(b, nc, chunk, n)
    dtc = dt.reshape(b, nc, chunk, h)
    state = (torch.zeros((b, h, n, pdim), dtype=torch.float32, device=x.device)
             if init_state is None else init_state)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    ys = []
    for c in range(nc):
        xc, bc, cc, dtk = xf[:, c], bf[:, c], cf[:, c], dtc[:, c]
        cum = torch.cumsum(dtk * A, dim=1)                    # [B, L, H], inclusive
        total = cum[:, -1]                                    # [B, H]
        # carry-state contribution: y_state[t] = exp(cum_t) C_t . S
        y_state = torch.einsum("bln,bhnp->blhp", cc, state) * torch.exp(cum)[..., None]
        # intra-chunk: W[t,s] = (C_t.B_s) exp(cum_t - cum_s) dt_s  (t >= s)
        cb = torch.einsum("bln,bmn->blm", cc, bc)
        gamma = torch.exp(cum[:, :, None, :] - cum[:, None, :, :])   # [B, L, L, H]
        w = torch.where(tri[None, :, :, None], cb[..., None] * gamma * dtk[:, None, :, :],
                        torch.zeros((), dtype=torch.float32, device=x.device))
        y_intra = torch.einsum("blmh,bmhp->blhp", w, xc)
        # S' = exp(total) S + sum_s exp(total - cum_s) dt_s B_s x_s
        decay_s = torch.exp(total[:, None, :] - cum) * dtk
        state = state * torch.exp(total)[:, :, None, None] + torch.einsum(
            "bln,blhp,blh->bhnp", bc, xc, decay_s)
        ys.append(y_state + y_intra)
    return torch.stack(ys, dim=1).reshape(b, s, h, pdim), state


def ssd_ref(x, dt, A, Bm, Cm):
    """Token-by-token recurrence oracle (tests)."""
    b, s, h, pdim = x.shape
    n = Bm.shape[-1]
    state = torch.zeros((b, h, n, pdim), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        lam = torch.exp(dt[:, t] * A)
        upd = torch.einsum("bn,bhp,bh->bhnp", Bm[:, t].float(), x[:, t].float(), dt[:, t])
        state = state * lam[:, :, None, None] + upd
        ys.append(torch.einsum("bn,bhnp->bhp", Cm[:, t].float(), state))
    return torch.stack(ys, dim=1), state


def _gate_out(p: Params, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Gated norm (B2) and the out projection (B1)."""
    return linear(rmsnorm(y * F.silu(z), p["gate_norm"]), p["wo"])


def ssd_apply(p: Params, xin: torch.Tensor, cfg, *, chunk: int = 128) -> torch.Tensor:
    """Full SSD block: proj → conv → SSD scan → gated norm → out proj."""
    y, _, z = _mix(p, xin, cfg, chunk=chunk)
    return _gate_out(p, y, z)


def _mix(p: Params, xin: torch.Tensor, cfg, *, chunk: int = 128):
    """(y [B, S, d_inner] in ``xin``'s type, final state, z)."""
    x, z, bm, cm, dt = _inputs(p, xin, cfg)
    y, final = ssd_scan(x, dt, -torch.exp(p["A_log"]), bm, cm, chunk=chunk)
    y = y + x.float() * p["D"][:, None]
    b, s = xin.shape[:2]
    return y.reshape(b, s, cfg.ssm_d_inner).to(xin.dtype), final, z


def ssd_prefill(p: Params, xin: torch.Tensor, cfg, state: Params) -> Tuple[torch.Tensor, Params]:
    """The block on a prompt, writing its final recurrent state and its
    conv history (the last ``CONV_K - 1`` pre-activation conv inputs)
    into ``state`` in place; returns the block's output and ``state``."""
    y, final, z = _mix(p, xin, cfg)
    state["ssm"].copy_(final)
    u = torch.cat([linear(xin, p["wx"]), linear(xin, p["wB"]), linear(xin, p["wC"])], dim=-1)
    state["conv"].copy_(u[:, -(CONV_K - 1):])
    return _gate_out(p, y, z), state


# ---------------------------------------------------------------------------
# decode (O(1) per token)
# ---------------------------------------------------------------------------


def ssd_state_init(cfg, batch: int, dtype, device="cpu", lead=()) -> Params:
    """The decode state, the JAX package's layout and types: ``ssm``
    ``[B, H, N, P]`` f32, ``conv`` ``[B, CONV_K - 1, d_inner + 2N]`` in
    the model's type; ``lead`` prepends stacking dims."""
    return {
        "ssm": torch.zeros((*lead, batch, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_headdim),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros((*lead, batch, CONV_K - 1, cfg.ssm_d_inner + 2 * cfg.ssm_state),
                            dtype=dtype, device=device),
    }


def decode_mix(u: torch.Tensor, dt_raw: torch.Tensor, conv_w, dt_bias, a_log, d_skip,
               ssm_state: torch.Tensor, conv_state: torch.Tensor, *, heads: int, head_dim: int,
               d_inner: int, state: int):
    """One recurrent step on the projected inputs: ``u`` the
    concatenated ``[B, d_inner + 2N]`` x|B|C projections, ``dt_raw``
    ``[B, H]``. Returns (y [B, d_inner] f32, new ssm state, new conv
    history in ``conv_state``'s type) — the shared body of
    :func:`ssd_decode` and the compiled ``ssm_decode`` backend."""
    b = u.shape[0]
    hist = torch.cat([conv_state, u[:, None].to(conv_state.dtype)], dim=1)
    conv_out = torch.einsum("bkc,kc->bc", hist.float(), conv_w.float())
    u_act = F.silu(conv_out)
    xs, bs, cs = u_act[:, :d_inner], u_act[:, d_inner: d_inner + state], u_act[:, d_inner + state:]
    dt = F.softplus(dt_raw.float() + dt_bias)
    lam = torch.exp(dt * -torch.exp(a_log))
    xh = xs.reshape(b, heads, head_dim)
    s_new = ssm_state * lam[:, :, None, None] + torch.einsum("bn,bhp,bh->bhnp", bs, xh, dt)
    y = torch.einsum("bn,bhnp->bhp", cs, s_new) + xh * d_skip[:, None]
    return y.reshape(b, d_inner), s_new, hist[:, 1:]


def ssd_decode(p: Params, xin: torch.Tensor, cfg, state: Params) -> Tuple[torch.Tensor, Params]:
    """xin [B, 1, d]; returns (y [B, 1, d], ``state``), the state
    advanced in place (the JAX package returns a new one)."""
    b = xin.shape[0]
    x = linear(xin, p["wx"])
    z = linear(xin, p["wz"])
    u = torch.cat([x, linear(xin, p["wB"]), linear(xin, p["wC"])], dim=-1)[:, 0]
    y, s_new, conv = decode_mix(
        u, linear(xin[:, 0], p["wdt"]), p["conv_w"], p["dt_bias"], p["A_log"], p["D"],
        state["ssm"], state["conv"], heads=cfg.ssm_heads, head_dim=cfg.ssm_headdim,
        d_inner=cfg.ssm_d_inner, state=cfg.ssm_state)
    state["ssm"].copy_(s_new)
    state["conv"].copy_(conv)
    return _gate_out(p, y.reshape(b, 1, -1).to(xin.dtype), z), state
