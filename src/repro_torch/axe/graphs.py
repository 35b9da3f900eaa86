"""Representative op graphs for layout propagation, layout search, and
compiled execution.

``decoder_layer_graph`` builds the op graph of one decoder layer for a
model-zoo config; ``model_graph`` builds the whole-model graph — embed →
N decoder layers → lm_head — with family variants: dense / MoE
(dispatch + expert GEMMs + combine), SSM and hybrid mixers
(Mamba2/Jamba), and the encoder–decoder stack with cross-attention
(Whisper). Reshape boundaries are *in-graph* ``reshape`` nodes, so a
sharding a reshape cannot carry is paid for as an AllGather in the plan
rather than silently dropped.

Every graph is a :class:`GraphSpec`: the node list, per-input tensor
metadata (shape / dtype / role / the rule engine's seeded preference
list), and the physical space. ``seeded_env()`` resolves the preference
lists through ``rules.pick_spec`` — that is the baseline plan the layout
solver (``repro_torch.axe.solve``) has to beat; the solver itself enumerates
placements from the spec algebra instead of the preference lists.

Since ``axe.compile`` these graphs are *executable*: every node carries
the execution attrs its backend needs (norm weights, rope/qk-norm/mask
parameters on the q/k/v boundary nodes, router + capacity metadata on
the MoE nodes, the SSD mixer's auxiliary tensors) referencing small
replicated auxiliary parameters by name. Projections are split exactly
as the reference models keep them (``wq``/``wk``/``wv``, the SwiGLU
``wg``/``wu`` pair, per-expert ``moe_wg``/``moe_wu``) so a solved
placement of a graph weight is directly a placement of the model leaf
and the local shards line up with head/feature boundaries. The
propagation rules ignore attrs they do not read, so the layout
semantics stay those of the plain op kinds.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from repro_torch.axe import rules
from repro_torch.axe.propagate import OpNode
from repro_torch.axe.spec import AxeSpec, PhysicalSpace


@dataclasses.dataclass(frozen=True)
class TensorMeta:
    """One graph input: logical shape + dtype + the seeded preference
    list (``rules`` syntax) the baseline plan resolves it with."""

    name: str
    shape: Tuple[int, ...]
    dtype: str
    role: str                      # "activation" | "param" | "cache"
    prefs: Tuple[Tuple, ...] = ()


@dataclasses.dataclass
class GraphSpec:
    """An op graph plus everything needed to seed or solve its layout.

    ``extra_outputs`` names tensors that are graph results *in addition
    to* being consumed by later nodes — the cache-out boundary of the
    decode-step graphs, where the updated KV cache both feeds the
    attention node and must leave the executable for the next step."""

    nodes: List[OpNode]
    inputs: Dict[str, TensorMeta]
    space: PhysicalSpace
    extra_outputs: Tuple[str, ...] = ()

    def seeded_env(self) -> Dict[str, AxeSpec]:
        """The rule-engine baseline: first admissible preference per
        input (replication when nothing in the list is admissible)."""
        env: Dict[str, AxeSpec] = {}
        for m in self.inputs.values():
            if m.prefs:
                env[m.name] = rules.pick_spec(m.shape, m.prefs, self.space, m.dtype)
            else:
                env[m.name] = AxeSpec.replicated(m.shape, self.space, m.dtype)
        return env

    def outputs(self) -> Tuple[str, ...]:
        """Tensors produced but never consumed (the graph results),
        plus any declared ``extra_outputs`` — in node order."""
        consumed = {i for n in self.nodes for i in n.inputs}
        extra = set(self.extra_outputs)
        return tuple(
            n.out for n in self.nodes
            if n.out not in consumed or n.out in extra
        )


class _Builder:
    """Accumulates nodes + input metadata while building one graph."""

    def __init__(self, space: PhysicalSpace, dtype: str):
        self.space = space
        self.dtype = dtype
        self.nodes: List[OpNode] = []
        self.inputs: Dict[str, TensorMeta] = {}
        self.extra_outputs: List[str] = []

    def inp(self, name: str, shape, role: str, prefs=(), dtype=None) -> str:
        self.inputs[name] = TensorMeta(
            name, tuple(int(s) for s in shape), dtype or self.dtype, role,
            tuple(tuple(p) for p in prefs),
        )
        return name

    def op(self, name: str, kind: str, ins, out: str, attrs=()) -> str:
        self.nodes.append(OpNode(name, kind, tuple(ins), out, tuple(attrs)))
        return out

    def reshape(self, name: str, src: str, shape, carry, extra=()) -> str:
        return self.op(
            name, "reshape", (src,), name,
            attrs=(("shape", tuple(int(s) for s in shape)),
                   ("carry", tuple(tuple(c) for c in carry)))
            + tuple(extra),
        )

    def mark_output(self, name: str) -> str:
        self.extra_outputs.append(name)
        return name

    def spec(self) -> GraphSpec:
        return GraphSpec(self.nodes, self.inputs, self.space,
                         tuple(self.extra_outputs))


def capacity(tokens: int, cfg) -> int:
    """Per-expert MoE capacity — the jax-free twin of
    ``repro_torch.models.moe.capacity`` (parity asserted in tests) so graph
    metadata matches what the reference models and the compiled
    executor actually allocate."""
    c = int(tokens * cfg.experts_per_tok * cfg.capacity_factor / cfg.num_experts)
    return max(8, -(-c // 8) * 8)


def _layer_window(cfg, i: int):
    """Per-layer sliding window, mirroring ``models.transformer``:
    local/global families window the first ``ratio`` layers of each
    period; otherwise the config window applies uniformly."""
    if cfg.local_global_ratio:
        per = cfg.local_global_ratio + 1
        return cfg.sliding_window if (i % per) < cfg.local_global_ratio else None
    return cfg.sliding_window


# ---------------------------------------------------------------------------
# per-layer builders
# ---------------------------------------------------------------------------


def _attention_block(
    b: _Builder, cfg, batch: int, seq: int, p: str, x_in: str,
    *, layer_index: int = 0, causal: bool = True,
    kv_from: str = None, kv_tokens: int = None, kv_seq: int = None,
) -> str:
    """norm → q/k/v projections → attention → output projection →
    residual. ``kv_from`` switches to cross-attention: K/V project from
    that tensor (the encoder output) instead of the normed input."""
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    t = batch * seq
    cross = kv_from is not None
    x_n = b.op(f"{p}norm_in", "norm", (x_in,), f"{p}x_n",
               attrs=(("weight", f"{p}norm1"),))
    # cross-attention weights get non-colliding base names (cwq/cwk/...)
    # so PlanRules never mistakes them for the self-attention projections
    wq = b.inp(f"{p}cwq" if cross else f"{p}wq", (d, h * hd), "param",
               [(None, "model"), (None, None)])
    wk = b.inp(f"{p}cwk" if cross else f"{p}wk", (d, kv * hd), "param",
               [(None, "model"), (None, None)])
    wv = b.inp(f"{p}cwv" if cross else f"{p}wv", (d, kv * hd), "param",
               [(None, "model"), (None, None)])
    kv_src = kv_from if cross else x_n
    kv_s = seq if not cross else (
        kv_seq if kv_seq is not None else (kv_tokens // batch)
    )
    qf = b.op(f"{p}q_proj", "matmul", (x_n, wq), f"{p}qf")
    kf = b.op(f"{p}k_proj", "matmul", (kv_src, wk), f"{p}kf")
    vf = b.op(f"{p}v_proj", "matmul", (kv_src, wv), f"{p}vf")
    # the reference models rope + qk-norm at this boundary (never for
    # cross-attention), so the select nodes carry those execution attrs
    rope = None if cross else cfg.rope_theta
    qk = (not cross) and cfg.qk_norm

    def sel(role, heads, extra=()):
        # only q and k are rotary-embedded; v passes through
        theta = rope if role in ("q", "k") else None
        return (("select", role), ("heads", heads), ("head_dim", hd),
                ("batch", batch), ("rope_theta", theta)) + tuple(extra)

    q = b.reshape(f"{p}q", qf, (batch, h, seq, hd), ((0, 0), (1, 1)),
                  extra=sel("q", h, (("norm_weight", f"{p}q_norm" if qk else None),)))
    k = b.reshape(f"{p}k", kf, (batch, kv, kv_s, hd), ((0, 0), (1, 1)),
                  extra=sel("k", kv, (("norm_weight", f"{p}k_norm" if qk else None),)))
    v = b.reshape(f"{p}v", vf, (batch, kv, kv_s, hd), ((0, 0), (1, 1)),
                  extra=sel("v", kv))
    attn = b.op(f"{p}attention", "attention", (q, k, v), f"{p}attn_out",
                attrs=(("causal", causal and not cross),
                       ("window", None if cross else _layer_window(cfg, layer_index))))
    flat = b.reshape(f"{p}attn_flat", attn, (t, h * hd), ((0, 0), (1, 1)),
                     extra=(("select", "merge_heads"), ("batch", batch)))
    wo = b.inp(f"{p}cwo" if cross else f"{p}wo",
               (h * hd, d), "param", [("model", None), (None, None)])
    o = b.op(f"{p}wo_proj", "matmul", (flat, wo), f"{p}attn_o")
    return b.op(f"{p}attn_residual", "elementwise", (o, x_in), f"{p}x1",
                attrs=(("fn", "add"),))


def _ssm_block(b: _Builder, cfg, batch: int, seq: int, p: str, x_in: str) -> str:
    """norm → (x/z/B/C/dt projections) → SSD mix → gate → gated norm →
    out proj → residual; the Mamba2 mixer as layout ops."""
    d = cfg.d_model
    di, n, h = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads
    x_n = b.op(f"{p}norm_in", "norm", (x_in,), f"{p}x_n",
               attrs=(("weight", f"{p}norm1"),))
    wx = b.inp(f"{p}wx", (d, di), "param", [(None, "model"), (None, None)])
    wz = b.inp(f"{p}wz", (d, di), "param", [(None, "model"), (None, None)])
    wB = b.inp(f"{p}wB", (d, n), "param", [(None, None)])
    wC = b.inp(f"{p}wC", (d, n), "param", [(None, None)])
    wdt = b.inp(f"{p}wdt", (d, h), "param", [(None, "model"), (None, None)])
    xz = b.op(f"{p}x_proj", "matmul", (x_n, wx), f"{p}xz")
    zz = b.op(f"{p}z_proj", "matmul", (x_n, wz), f"{p}zz")
    bb = b.op(f"{p}b_proj", "matmul", (x_n, wB), f"{p}bb")
    cc = b.op(f"{p}c_proj", "matmul", (x_n, wC), f"{p}cc")
    dt = b.op(f"{p}dt_proj", "matmul", (x_n, wdt), f"{p}dt")
    y = b.op(f"{p}ssm_mix", "ssm_mix", (xz, bb, cc, dt), f"{p}y",
             attrs=(("batch", batch), ("seq", seq),
                    ("heads", h), ("head_dim", cfg.ssm_headdim),
                    ("state", n), ("d_inner", di),
                    ("dt_bias", f"{p}dt_bias"), ("A_log", f"{p}A_log"),
                    ("D", f"{p}D"), ("conv_w", f"{p}conv_w")))
    g = b.op(f"{p}gate", "elementwise", (y, zz), f"{p}g",
             attrs=(("fn", "mul_silu"),))
    gn = b.op(f"{p}gate_norm", "norm", (g,), f"{p}gn",
              attrs=(("weight", f"{p}gate_norm"),))
    wo = b.inp(f"{p}ssm_wo", (di, d), "param", [("model", None), (None, None)])
    o = b.op(f"{p}out_proj", "matmul", (gn, wo), f"{p}ssm_o")
    return b.op(f"{p}ssm_residual", "elementwise", (o, x_in), f"{p}x1",
                attrs=(("fn", "add"),))


def _ffn_block(b: _Builder, cfg, t: int, p: str, x_in: str, res: str) -> str:
    """norm → dense FFN or MoE dispatch/expert-GEMMs/combine → residual.

    The FFN keeps the reference models' structure — a SwiGLU gate pair
    (``wg``/``wu``) or a single GELU projection, per ``cfg.mlp_type`` —
    so the plan accounts for both GEMMs and the compiled executor
    reproduces the exact activation math."""
    d = cfg.d_model
    x2 = b.op(f"{p}norm_ffn", "norm", (x_in,), f"{p}x2",
              attrs=(("weight", f"{p}norm2"),))
    if cfg.is_moe:
        e, f_e = cfg.num_experts, cfg.moe_d_ff
        cap = capacity(t, cfg)
        moe_wg = b.inp(f"{p}moe_wg", (e, d, f_e), "param",
                       [("model", None, None), (None, None, "model"),
                        (None, None, None)])
        moe_wu = b.inp(f"{p}moe_wu", (e, d, f_e), "param",
                       [("model", None, None), (None, None, "model"),
                        (None, None, None)])
        moe_wo = b.inp(f"{p}moe_wo", (e, f_e, d), "param",
                       [("model", None, None), (None, "model", None),
                        (None, None, None)])
        xe = b.op(f"{p}moe_dispatch", "moe_dispatch", (x2,), f"{p}xe",
                  attrs=(("experts", e), ("capacity", cap),
                         ("experts_per_tok", cfg.experts_per_tok),
                         ("router", f"{p}router")))
        hg = b.op(f"{p}moe_ffn_g", "matmul", (xe, moe_wg), f"{p}hg")
        hu = b.op(f"{p}moe_ffn_u", "matmul", (xe, moe_wu), f"{p}hu")
        ha = b.op(f"{p}moe_act", "elementwise", (hg, hu), f"{p}ha",
                  attrs=(("fn", "swiglu"),))
        oe = b.op(f"{p}moe_ffn_out", "matmul", (ha, moe_wo), f"{p}oe")
        out = b.op(f"{p}moe_combine", "moe_combine", (oe,), f"{p}moe_out",
                   attrs=(("tokens", t), ("dispatch", f"{p}xe"),
                          ("dispatch_input", f"{p}x2"),
                          ("experts", e), ("capacity", cap)))
        return b.op(f"{p}ffn_residual", "elementwise", (out, res), f"{p}x_out",
                    attrs=(("fn", "add"),))
    if cfg.mlp_type == "swiglu":
        wg = b.inp(f"{p}wg", (d, cfg.d_ff), "param", [(None, "model"), (None, None)])
        wu = b.inp(f"{p}wu", (d, cfg.d_ff), "param", [(None, "model"), (None, None)])
        hg = b.op(f"{p}ffn_g", "matmul", (x2, wg), f"{p}hgd")
        hu = b.op(f"{p}ffn_u", "matmul", (x2, wu), f"{p}hud")
        hh = b.op(f"{p}ffn_act", "elementwise", (hg, hu), f"{p}ffn_h",
                  attrs=(("fn", "swiglu"),))
    else:
        wi = b.inp(f"{p}wi", (d, cfg.d_ff), "param", [(None, "model"), (None, None)])
        h0 = b.op(f"{p}ffn_in", "matmul", (x2, wi), f"{p}ffn_h0")
        hh = b.op(f"{p}ffn_act", "elementwise", (h0,), f"{p}ffn_h",
                  attrs=(("fn", "gelu"),))
    wo2 = b.inp(f"{p}wo2", (cfg.d_ff, d), "param", [("model", None), (None, None)])
    oo = b.op(f"{p}ffn_out", "matmul", (hh, wo2), f"{p}ffn_o")
    return b.op(f"{p}ffn_residual", "elementwise", (oo, res), f"{p}x_out",
                attrs=(("fn", "add"),))


def _mixer_kind(cfg, i: int) -> str:
    if cfg.family == "ssm":
        return "ssm"
    if cfg.family == "hybrid":
        per = max(cfg.attn_period, 1)
        return "attn" if i % per == per - 1 else "ssm"
    return "attn"


def _decoder_layer(
    b: _Builder, cfg, batch: int, seq: int, p: str, x_in: str,
    *, layer_index: int = 0, enc_out: str = None, enc_tokens: int = None,
    enc_seq: int = None,
) -> str:
    """One decoder layer; returns the layer output tensor name."""
    t = batch * seq
    if _mixer_kind(cfg, layer_index) == "ssm":
        x1 = _ssm_block(b, cfg, batch, seq, p, x_in)
    else:
        x1 = _attention_block(b, cfg, batch, seq, p, x_in,
                              layer_index=layer_index)
        if enc_out is not None:
            # encoder-decoder: cross-attention sub-block after self-attn
            x1 = _attention_block(
                b, cfg, batch, seq, f"{p}cross.", x1,
                kv_from=enc_out, kv_tokens=enc_tokens, kv_seq=enc_seq,
            )
    if not (cfg.is_moe or cfg.d_ff):
        return x1  # pure SSM block (mamba2): mixer only
    return _ffn_block(b, cfg, t, p, x1, x1)


# ---------------------------------------------------------------------------
# public graph builders
# ---------------------------------------------------------------------------


def layer_graph_spec(
    cfg, batch: int, seq: int, space: PhysicalSpace, dtype: str = "bfloat16",
) -> GraphSpec:
    """One decoder layer as a :class:`GraphSpec` with a free activation
    input ``x`` — the single-layer graph ``dryrun --layout-plan`` and
    the propagation tests use."""
    b = _Builder(space, dtype)
    dp = rules.dp_entry(space)
    b.inp("x", (batch * seq, cfg.d_model), "activation",
          [(dp, None), (None, None)])
    _decoder_layer(b, cfg, batch, seq, "", "x")
    return b.spec()


def decoder_layer_graph(
    cfg,
    batch: int,
    seq: int,
    space: PhysicalSpace,
    dtype: str = "bfloat16",
) -> Tuple[List[OpNode], Dict[str, AxeSpec]]:
    """One decoder layer as (nodes, seeded input specs) for
    ``propagate`` — the historical entry point, now a view over
    :func:`layer_graph_spec`. Reshape boundaries are in-graph nodes, so
    placements the new extents do not admit (GQA kv heads, non-dividing
    head counts) cost an AllGather in the plan instead of being dropped
    silently."""
    gs = layer_graph_spec(cfg, batch, seq, space, dtype)
    return gs.nodes, gs.seeded_env()


def model_graph(
    cfg,
    batch: int,
    seq: int,
    space: PhysicalSpace,
    dtype: str = "bfloat16",
    *,
    layers: int = 2,
) -> GraphSpec:
    """The whole-model op graph: embed → ``layers`` decoder layers →
    final norm → lm_head, with the family variants (MoE, SSM/hybrid
    mixers, encoder–decoder cross-attention). ``layers`` caps the
    decoder depth (layout plans repeat per layer; two layers exercise
    every cross-layer boundary)."""
    b = _Builder(space, dtype)
    dp = rules.dp_entry(space)
    d, v = cfg.d_model, cfg.vocab_size
    t = batch * seq

    tokens = b.inp("tokens", (t,), "activation", [(dp,), (None,)], dtype="int32")
    embed = b.inp("embed", (v, d), "param", list(rules.PARAM_RULES["embed"]))
    x = b.op("embed_lookup", "embed", (tokens, embed), "x0")

    enc_out = None
    enc_t = enc_s = None
    if cfg.family == "encdec":
        enc_s = cfg.encoder_seq
        enc_t = batch * enc_s
        frames = b.inp("frames", (enc_t, d), "activation",
                       [(dp, None), (None, None)])
        e_x = frames
        for i in range(min(cfg.encoder_layers, layers)):
            p = f"E{i}."
            e_x1 = _attention_block(b, cfg, batch, enc_s, p, e_x, causal=False)
            e_x = _ffn_block(b, cfg, enc_t, p, e_x1, e_x1)
        enc_out = b.op("enc_norm", "norm", (e_x,), "enc_out",
                       attrs=(("weight", "enc_norm"),))

    n_layers = min(cfg.num_layers, layers)
    for i in range(n_layers):
        x = _decoder_layer(
            b, cfg, batch, seq, f"L{i}.", x,
            layer_index=i, enc_out=enc_out, enc_tokens=enc_t, enc_seq=enc_s,
        )

    x_f = b.op("final_norm", "norm", (x,), "x_f",
               attrs=(("weight", "final_norm"),))
    lm_head = b.inp("lm_head", (d, v), "param", list(rules.PARAM_RULES["lm_head"]))
    b.op("lm_head_proj", "matmul", (x_f, lm_head), "logits")
    return b.spec()


# ---------------------------------------------------------------------------
# decode-step graphs: the KV cache as a first-class graph tensor
# ---------------------------------------------------------------------------

#: causal-conv filter taps — the jax-free twin of ``models.ssm.CONV_K``
#: (parity asserted in tests) so the conv-state cache input matches the
#: reference ``ssd_state_init`` leaf exactly
CONV_K = 4


def cache_window(cfg, layer_index: int, max_seq: int) -> int:
    """The cache length of one layer: its sliding window (ring buffer)
    capped at ``max_seq``, or the full ``max_seq`` — exactly
    ``models.transformer.cache_init``'s per-layer allocation."""
    w = _layer_window(cfg, layer_index)
    return min(w, max_seq) if w else max_seq


def _attention_decode_block(
    b: _Builder, cfg, batch: int, max_seq: int, p: str, x_in: str,
    *, layer_index: int = 0,
) -> str:
    """One decode step of the attention mixer: norm → q/k/v projections
    → rope/qk-norm at the *runtime* position (``decode_select``) → cache
    write at that position (``cache_update`` — the cache-in/cache-out
    boundary) → single-token attention over the laid-out cache
    (``decode_attention``) → output projection → residual."""
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    window = _layer_window(cfg, layer_index)
    w_len = cache_window(cfg, layer_index, max_seq)
    ring = window is not None
    x_n = b.op(f"{p}norm_in", "norm", (x_in,), f"{p}x_n",
               attrs=(("weight", f"{p}norm1"),))
    wq = b.inp(f"{p}wq", (d, h * hd), "param", [(None, "model"), (None, None)])
    wk = b.inp(f"{p}wk", (d, kv * hd), "param", [(None, "model"), (None, None)])
    wv = b.inp(f"{p}wv", (d, kv * hd), "param", [(None, "model"), (None, None)])
    qf = b.op(f"{p}q_proj", "matmul", (x_n, wq), f"{p}qf")
    kf = b.op(f"{p}k_proj", "matmul", (x_n, wk), f"{p}kf")
    vf = b.op(f"{p}v_proj", "matmul", (x_n, wv), f"{p}vf")
    qk = cfg.qk_norm

    def sel(role, heads, extra=()):
        theta = cfg.rope_theta if role in ("q", "k") else None
        return (("select", role), ("heads", heads), ("head_dim", hd),
                ("batch", batch), ("rope_theta", theta)) + tuple(extra)

    q = b.op(f"{p}q", "decode_select", (qf, "pos"), f"{p}q",
             attrs=sel("q", h, (("norm_weight", f"{p}q_norm" if qk else None),)))
    k = b.op(f"{p}k", "decode_select", (kf, "pos"), f"{p}k",
             attrs=sel("k", kv, (("norm_weight", f"{p}k_norm" if qk else None),)))
    v = b.op(f"{p}v", "decode_select", (vf, "pos"), f"{p}v",
             attrs=sel("v", kv))
    # cache-in: a first-class graph tensor the solver places like any
    # other (batch-sharded and/or kv-head-sharded; the ring/linear write
    # keeps the position dim locally complete)
    cache_prefs = [(rules.dp_entry(b.space), None, "model", None),
                   (None, None, "model", None),
                   (rules.dp_entry(b.space), None, None, None),
                   (None, None, None, None)]
    k_cache = b.inp(f"{p}k_cache", (batch, w_len, kv, hd), "cache", cache_prefs)
    v_cache = b.inp(f"{p}v_cache", (batch, w_len, kv, hd), "cache", cache_prefs)
    kco = b.op(f"{p}k_cache_write", "cache_update", (k_cache, k, "pos"),
               f"{p}k_cache_out", attrs=(("ring", ring),))
    vco = b.op(f"{p}v_cache_write", "cache_update", (v_cache, v, "pos"),
               f"{p}v_cache_out", attrs=(("ring", ring),))
    b.mark_output(kco)
    b.mark_output(vco)
    attn = b.op(f"{p}decode_attention", "decode_attention",
                (q, kco, vco, "pos"), f"{p}attn_out",
                attrs=(("ring", ring),))
    flat = b.reshape(f"{p}attn_flat", attn, (batch, h * hd), ((0, 0), (1, 1)),
                     extra=(("select", "merge_heads"), ("batch", batch)))
    wo = b.inp(f"{p}wo", (h * hd, d), "param", [("model", None), (None, None)])
    o = b.op(f"{p}wo_proj", "matmul", (flat, wo), f"{p}attn_o")
    return b.op(f"{p}attn_residual", "elementwise", (o, x_in), f"{p}x1",
                attrs=(("fn", "add"),))


def _ssm_decode_block(b: _Builder, cfg, batch: int, p: str, x_in: str) -> str:
    """One decode step of the SSD mixer: the recurrent state and the
    causal-conv history are cache-in tensors; ``ssm_decode`` advances
    them one token and the ``side_output`` boundary nodes surface the
    new states as graph outputs."""
    d = cfg.d_model
    di, n, h = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads
    dp = rules.dp_entry(b.space)
    x_n = b.op(f"{p}norm_in", "norm", (x_in,), f"{p}x_n",
               attrs=(("weight", f"{p}norm1"),))
    wx = b.inp(f"{p}wx", (d, di), "param", [(None, "model"), (None, None)])
    wz = b.inp(f"{p}wz", (d, di), "param", [(None, "model"), (None, None)])
    wB = b.inp(f"{p}wB", (d, n), "param", [(None, None)])
    wC = b.inp(f"{p}wC", (d, n), "param", [(None, None)])
    wdt = b.inp(f"{p}wdt", (d, h), "param", [(None, "model"), (None, None)])
    xz = b.op(f"{p}x_proj", "matmul", (x_n, wx), f"{p}xz")
    zz = b.op(f"{p}z_proj", "matmul", (x_n, wz), f"{p}zz")
    bb = b.op(f"{p}b_proj", "matmul", (x_n, wB), f"{p}bb")
    cc = b.op(f"{p}c_proj", "matmul", (x_n, wC), f"{p}cc")
    dt = b.op(f"{p}dt_proj", "matmul", (x_n, wdt), f"{p}dt")
    ssm_state = b.inp(f"{p}ssm_state", (batch, h, n, cfg.ssm_headdim), "cache",
                      [(dp, None, None, None), (None, None, None, None)],
                      dtype="float32")
    conv_state = b.inp(f"{p}conv_state", (batch, CONV_K - 1, di + 2 * n), "cache",
                       [(dp, None, None), (None, None, None)])
    y = b.op(f"{p}ssm_decode", "ssm_decode",
             (xz, bb, cc, dt, ssm_state, conv_state), f"{p}y",
             attrs=(("batch", batch),
                    ("heads", h), ("head_dim", cfg.ssm_headdim),
                    ("state", n), ("d_inner", di),
                    ("dt_bias", f"{p}dt_bias"), ("A_log", f"{p}A_log"),
                    ("D", f"{p}D"), ("conv_w", f"{p}conv_w")))
    # cache-out boundary: the advanced states the mixer computed, typed
    # like their cache-in tensors
    b.op(f"{p}ssm_state_write", "side_output", (y,), f"{p}ssm_state_out",
         attrs=(("side", y), ("channel", "ssm"), ("like", ssm_state)))
    b.op(f"{p}conv_state_write", "side_output", (y,), f"{p}conv_state_out",
         attrs=(("side", y), ("channel", "conv"), ("like", conv_state)))
    g = b.op(f"{p}gate", "elementwise", (y, zz), f"{p}g",
             attrs=(("fn", "mul_silu"),))
    gn = b.op(f"{p}gate_norm", "norm", (g,), f"{p}gn",
              attrs=(("weight", f"{p}gate_norm"),))
    wo = b.inp(f"{p}ssm_wo", (di, d), "param", [("model", None), (None, None)])
    o = b.op(f"{p}out_proj", "matmul", (gn, wo), f"{p}ssm_o")
    return b.op(f"{p}ssm_residual", "elementwise", (o, x_in), f"{p}x1",
                attrs=(("fn", "add"),))


def decode_graph(
    cfg,
    batch: int,
    max_seq: int,
    space: PhysicalSpace,
    dtype: str = "bfloat16",
    *,
    layers: int = None,
) -> GraphSpec:
    """The single-token decode step as an op graph: embed the current
    token → per-layer mixers reading and writing their cache tensors at
    the runtime position ``pos`` → next-token logits.

    Activations are ``tokens [batch]`` and ``pos [batch]`` (per-slot
    positions, so a continuous batcher can decode requests at different
    depths in one step); cache tensors are named inputs
    (``L{i}.k_cache`` / ``L{i}.v_cache`` / ``L{i}.ssm_state`` /
    ``L{i}.conv_state``) shaped exactly like the reference
    ``cache_init`` leaves for one super-block slot, and the updated
    caches come back as graph outputs alongside ``logits``."""
    b = _Builder(space, dtype)
    dp = rules.dp_entry(space)
    d, v = cfg.d_model, cfg.vocab_size

    b.inp("tokens", (batch,), "activation", [(dp,), (None,)], dtype="int32")
    b.inp("pos", (batch,), "activation", [(dp,), (None,)], dtype="int32")
    embed = b.inp("embed", (v, d), "param", list(rules.PARAM_RULES["embed"]))
    x = b.op("embed_lookup", "embed", ("tokens", embed), "x0")

    n_layers = cfg.num_layers if layers is None else min(cfg.num_layers, layers)
    for i in range(n_layers):
        p = f"L{i}."
        if _mixer_kind(cfg, i) == "ssm":
            x = _ssm_decode_block(b, cfg, batch, p, x)
        else:
            x = _attention_decode_block(b, cfg, batch, max_seq, p, x,
                                        layer_index=i)
        if cfg.is_moe or cfg.d_ff:
            x = _ffn_block(b, cfg, batch, p, x, x)

    x_f = b.op("final_norm", "norm", (x,), "x_f",
               attrs=(("weight", "final_norm"),))
    lm_head = b.inp("lm_head", (d, v), "param", list(rules.PARAM_RULES["lm_head"]))
    b.op("lm_head_proj", "matmul", (x_f, lm_head), "logits")
    return b.spec()
