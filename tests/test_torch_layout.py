"""The port's layout algebra against the JAX package's: ``core.za``,
``core.layout``, ``core.axes``, ``core.dtensor`` and ``axe.spec`` must
give the same canonical forms, ``repr``s, signatures, induced maps and
errors, since layout signatures are the keys plans and schedules compare
on. Every construction is written once as a function of a namespace of
modules and run against both packages (``REF``, ``PORT``); the results
are compared as strings. The cases are those of ``tests/test_layout.py``,
``test_layout_laws.py``, ``test_axespec.py`` and ``test_dtensor.py``, plus
layouts drawn by ``tests/_hyp.py``'s strategies with a fixed seed."""
import importlib
import math
import types

import pytest
from _hyp import given, settings, st
from jax.sharding import PartitionSpec as P

import repro.axe.spec as r_spec
import repro.core.axes as r_axes
import repro.core.collective as r_coll
import repro.core.dtensor as r_dtensor
import repro.core.layout as r_layout
import repro.tune.schedule as r_sched
import repro_torch.axe.spec as p_spec
import repro_torch.core.axes as p_axes
import repro_torch.core.collective as p_coll
import repro_torch.core.dtensor as p_dtensor
import repro_torch.core.layout as p_layout
import repro_torch.tune.schedule as p_sched
from repro.axe.lower import pspec_of_layout as r_pspec_of_layout

# the packages' ``core/__init__`` export a function ``za`` that shadows
# the submodule as an attribute
r_za = importlib.import_module("repro.core.za")
p_za = importlib.import_module("repro_torch.core.za")

REF = types.SimpleNamespace(L=r_layout, za=r_za, axes=r_axes, dt=r_dtensor, spec=r_spec,
                            coll=r_coll, sched=r_sched)
PORT = types.SimpleNamespace(L=p_layout, za=p_za, axes=p_axes, dt=p_dtensor, spec=p_spec,
                             coll=p_coll, sched=p_sched)


def _canon(x):
    """A package-independent string form of a result."""
    if isinstance(x, (set, frozenset)):
        return "{" + ", ".join(sorted(_canon(v) for v in x)) + "}"
    if isinstance(x, (list, tuple)):
        return "(" + ", ".join(_canon(v) for v in x) + ")"
    if isinstance(x, dict):
        return "{" + ", ".join(f"{_canon(k)}: {_canon(v)}" for k, v in sorted(x.items())) + "}"
    return repr(x)


def _run(fn, ns):
    try:
        return True, _canon(fn(ns))
    except Exception as e:  # the same error in both packages is parity too
        return False, f"{type(e).__name__}: {e}"


def same(fn, *, raises=False):
    """``fn(ns)`` gives the same result in both packages, or (with
    ``raises``) the same error; ``raises=None`` admits either."""
    (ok, want), (_, got) = _run(fn, REF), _run(fn, PORT)
    if raises is not None:
        assert ok != raises, want
    assert got == want
    return got


# ---------------------------------------------------------------------------
# layouts as plain data: ((extent, stride, axis), ...) for D and R, O
# ---------------------------------------------------------------------------


def mk(ns, d, r=(), o=None):
    it = ns.L.It
    O = ns.za.za(**{o[0]: o[1]}) if o else ns.za.ZA.zero
    return ns.L.Layout(tuple(it(*x) for x in d), tuple(it(*x) for x in r), O)


FIXED_LAYOUTS = [
    (((4, 1, "m"),),),
    (((2, 8, "m"), (4, 1, "m")),),
    (((3, 2, "x"), (2, 9, "m")),),
    (((2, -3, "m"), (3, 1, "x")),),
    (((2, 4, "m"), (2, 1, "x")), ((2, 16, "y"),)),
    (((4, 2, "m"),), ((2, 16, "x"),), ("x", 1)),
    (((2, 3, "m"), (2, 1, "m")), ((3, 4, "x"),), ("m", 2)),
    # test_axespec.py FIXED_CANON
    (((2, 4, "m"), (2, 2, "m"), (2, 1, "m")),),
    (((4, 1, "data"), (8, 1, "m")), ((2, 16, "x"), (2, -4, "x"))),
    (((6, 5, "m"),), ((3, 7, "x"),), ("m", 9)),
    (((1, 3, "m"), (5, 2, "m")),),
    # the paper's worked examples
    (((8, 4, "lane"), (2, 1, "warp"), (4, 1, "lane"), (2, 1, "reg")), ((2, 4, "warp"),),
     ("warp", 5)),
    (((2, 1, "gpuid"), (32, 128, "m"), (2, 2, "gpuid"), (64, 1, "m")),),
    (((2, 1, "gpuid"), (32, 128, "m"), (128, 1, "m")), ((2, 2, "gpuid"),)),
    (((2, 1, "m"),), ((2, 4, "x"), (2, 8, "x"))),
    (((2, 1, "m"),), ((3, -2, "x"),)),
]

FIXED_PAIRS = [
    ((((2, 1, "m"),),), (((4, 1, "m"),),)),
    ((((2, 3, "m"),),), (((3, 1, "m"),),)),
    ((((2, 2, "x"), (2, 1, "m")),), (((3, 1, "m"),),)),
    ((((2, 1, "m"),), ((2, 4, "x"),)), (((2, 2, "m"), (2, 1, "x")),)),
    ((((4, 4, "m"),),), (((4, 1, "m"),),)),
    ((((2, 12, "m"), (3, 4, "m")),), (((2, 2, "m"), (2, 1, "m")),)),
    ((((2, 1, "data"), (2, 2, "m")),), (((8, 1, "m"),),)),
    ((((4, 2, "m"),), ((2, 64, "x"),)), (((8, 1, "m"),),)),
    ((((2, 1, "model"),),), (((16, 1, "m"),),)),
]


def factorizations(n: int):
    out = [(n,)]
    for a in range(2, n + 1):
        if n % a == 0:
            b = n // a
            out.append((a, b))
            for c in range(2, b + 1):
                if b % c == 0:
                    out.append((a, c, b // c))
    return out


def _layout_facts(ns, spec):
    """Everything the algebra says about one layout."""
    L = mk(ns, *spec)
    C = ns.L.canonicalize(L)
    facts = [repr(L), repr(C), L.size, L.replication_degree, L.span(),
             repr(ns.L.canonicalize(C)), ns.L.layouts_equal(L, C)]
    if L.size > 64:  # the paper's mesh examples: too large to sweep
        return facts + [L.call_shaped((i * 37 % L.size,), (L.size,)) for i in range(64)]
    facts.append([repr(c) for c in L.enumerate_map()])
    for shape in factorizations(L.size):
        try:
            g = ns.L.group(L, shape)
            facts.append([repr(b) for b in g.blocks])
        except ns.L.GroupingError as e:
            facts.append(f"GroupingError: {e}")
    shape = (L.size,)
    for start in range(L.size):
        for size in range(1, L.size - start + 1):
            try:
                facts.append(repr(ns.L.slice_layout(L, (start,), (size,), shape)))
            except (ns.L.SliceError, ns.L.GroupingError) as e:
                facts.append(type(e).__name__)
    return facts


@pytest.mark.parametrize("idx", range(len(FIXED_LAYOUTS)))
def test_layout_canonical_forms_groups_and_slices_match(idx):
    same(lambda ns: _layout_facts(ns, FIXED_LAYOUTS[idx]))


def _pair_facts(ns, a, b):
    A, B = mk(ns, *a), mk(ns, *b)
    sa, sb = (A.size,), (B.size,)
    T, s_t = ns.L.tile(A, sa, B, sb)
    S, s_s = ns.L.direct_sum(A, sa, B, sb)
    facts = [repr(T), s_t, repr(ns.L.canonicalize(T)), repr(S), s_s,
             repr(ns.L.canonicalize(S)), [repr(c) for c in T.enumerate_map()]]
    rec = ns.L.tile_of(T, (T.size,), B, sb)
    facts.append(None if rec is None else (repr(rec[0]), rec[1]))
    return facts


@pytest.mark.parametrize("idx", range(len(FIXED_PAIRS)))
def test_layout_tile_direct_sum_and_tile_of_match(idx):
    same(lambda ns: _pair_facts(ns, *FIXED_PAIRS[idx]))


def test_layout_paper_examples_match():
    def facts(ns):
        L = ns.L.strided((2, 8, 3, 8), (192, 8, 64, 1))
        g = ns.L.group(L, (16, 24))
        T, s_t = ns.L.tile(ns.L.strided((2, 3), (3, 1)), (2, 3),
                           ns.L.strided((8, 8), (8, 1)), (8, 8))
        S, _ = ns.L.direct_sum(ns.L.strided((2, 2), (8, 2)), (2, 2),
                               ns.L.strided((2, 2), (4, 1)), (2, 2))
        out = ns.L.slice_layout(L, (0, 8), (8, 16), (16, 24))
        tc = mk(ns, *FIXED_LAYOUTS[11])
        return [[repr(b) for b in g.blocks], repr(T), s_t, repr(ns.L.canonicalize(S)),
                repr(ns.L.canonicalize(out)), repr(ns.L.from_shape((3, 5))),
                tc.call_shaped((1, 5), (8, 16)), tc.span_axis("warp"),
                ns.L.tile_of(ns.L.from_shape((16,)), (16,), ns.L.strided((2, 2), (4, 1)), (4,)),
                repr(ns.L.slice_layout(ns.L.from_shape((16,)), (6,), (4,), (16,)))]

    same(facts)


def test_za_arithmetic_and_reprs_match():
    def facts(ns):
        a, b = ns.za.za(m=3, x=-2), ns.za.za(x=2, warp=5)
        return [repr(a), repr(a + b), repr(a - b), repr(a * 3), repr(-a), repr(ns.za.ZA.zero),
                repr(ns.za.ZA.single("m", 4)), repr(ns.za.ZA.of(m=1, x=0)), a.is_zero,
                (a + b - b) == a, repr(a.scale_by({"m": 2, "x": 3})), repr(a.hadamard(b)),
                repr(a.abs()), a.items(), a.axes(), a.single_axis(), b["warp"]]

    same(facts)


def test_axes_registry_matches():
    def facts(ns):
        names = ("m", "sub", "lane", "grid_i", "data", "model", "pod", "expert", "pipe", "x")
        return [(n, ns.axes.is_mesh_axis(n)) for n in names] + [ns.axes.MEM_AXIS]

    same(facts)


# ---------------------------------------------------------------------------
# hypothesis: layouts drawn by _hyp's strategies with a fixed seed
# ---------------------------------------------------------------------------

AXES = ["m", "x", "y"]
_ITER = st.tuples(st.integers(1, 4), st.integers(-8, 8).filter(lambda s: s != 0),
                  st.sampled_from(AXES))
_RITER = st.tuples(st.integers(1, 4), st.integers(1, 8), st.sampled_from(AXES))
_LAYOUT = st.tuples(st.lists(_ITER, min_size=1, max_size=3),
                    st.lists(_RITER, min_size=0, max_size=1),
                    st.tuples(st.sampled_from(AXES), st.integers(-4, 4)))


def _small(spec):
    d, r, _ = spec
    return math.prod(x[0] for x in d) <= 24 and math.prod(x[0] for x in r) <= 4


@settings(max_examples=60, deadline=None, derandomize=True)
@given(_LAYOUT.filter(_small))
def test_drawn_layouts_match(spec):
    d, r, o = spec
    same(lambda ns: _layout_facts(ns, (tuple(d), tuple(r), o)))


@settings(max_examples=40, deadline=None, derandomize=True)
@given(_LAYOUT.filter(_small), _LAYOUT.filter(_small))
def test_drawn_layout_pairs_match(a, b):
    a = (tuple(a[0]), tuple(a[1]), a[2])
    b = (tuple(b[0]), tuple(b[1]), b[2])
    same(lambda ns: _pair_facts(ns, a, b))


# ---------------------------------------------------------------------------
# AxeSpec / PhysicalSpace / DTensorSpec
# ---------------------------------------------------------------------------

MESHES = [{"data": 4, "model": 4}, {"pod": 2, "data": 16, "model": 16}, {"model": 4},
          {"data": 2, "model": 4}]

SPECS = [
    ((64, 128), {0: ("data",), 1: ("model",)}, ()),
    ((64,), {}, ()),
    ((64, 128), {0: ("data",)}, ("model",)),
    ((8192, 4096), {0: ("pod", "data"), 1: ("model",)}, ()),
    ((64, 1024, 128), {0: ("data",), 1: ("model",)}, ()),
    ((32, 4096), {1: ("model", "pod")}, ()),
    ((6, 8), {0: ("data",)}, ()),                       # not divisible
    ((16, 8), {0: ("data",), 1: ("data",)}, ()),        # axis twice
    ((8,), {1: ("data",)}, ()),                         # dim out of range
    ((8, 16, 128, 64), {0: ("data",)}, ("model",)),
    ((4096, 512), {0: ("data", "model")}, ()),
]


def _spec_facts(ns, mesh, shape, placement, partial):
    space = ns.spec.PhysicalSpace.from_mesh_shape(mesh)
    s = ns.spec.AxeSpec.sharded(shape, space, placement, partial=partial)
    dt = s.to_dtensor()
    facts = [repr(space), space.signature(), repr(s), s.signature(), s.placement(),
             s.local_shape(), s.sharded_axes(), s.replication_axes(), s.bytes_per_device(2),
             repr(s.canonical()), repr(dt.layout), dt.bytes_per_device(space.mesh_shape, 2),
             ns.sched.layout_signature(s, None), ns.sched.layout_signature(s, tag="causal")]
    pspec = (r_pspec_of_layout if ns is REF else p_dtensor.pspec_of_layout)(
        dt.layout, dt.shape, space.mesh_shape)
    facts.append(tuple(pspec))
    rep = ns.spec.AxeSpec.replicated(shape, space)
    facts += [repr(rep), rep.signature(), s.equivalent(rep),
              ns.coll.infer_redistribution(dt, rep.to_dtensor(), space.mesh_shape,
                                           partial_axes=s.partial),
              ns.coll.infer_redistribution(rep.to_dtensor(), dt, space.mesh_shape)]
    steps = ns.coll.infer_redistribution(dt, rep.to_dtensor(), space.mesh_shape)
    facts.append(ns.coll.plan_comm_bytes(steps, dt, space.mesh_shape, 2))
    return facts


@pytest.mark.parametrize("mesh", range(len(MESHES)))
@pytest.mark.parametrize("case", range(len(SPECS)))
def test_axespec_signatures_placements_and_plans_match(mesh, case):
    # inadmissible placements (unknown axes, non-dividing extents) raise
    # the same SpecError in both
    same(lambda ns: _spec_facts(ns, MESHES[mesh], *SPECS[case]), raises=None)


def test_collective_steps_and_bytes_match_test_dtensor():
    def facts(ns):
        mesh = {"pod": 2, "data": 16, "model": 16}
        space = ns.spec.PhysicalSpace.from_mesh_shape(mesh)

        def d(shape, placement):
            return ns.spec.AxeSpec.sharded(shape, space, placement).to_dtensor()

        c = ns.coll
        out = [
            c.infer_redistribution(d((64, 128), {0: ("model",)}), d((64, 128), {}), mesh),
            c.infer_redistribution(d((64, 128), {0: ("model",)}), d((64, 128), {1: ("model",)}),
                                   mesh),
            c.infer_redistribution(d((64, 128), {}), d((64, 128), {0: ("data",)}), mesh),
            c.infer_redistribution(d((64, 64), {}), d((64, 64), {0: ("model",)}), mesh,
                                   partial_axes=("model",)),
            c.infer_redistribution(d((64, 64), {}), d((64, 64), {}), mesh,
                                   partial_axes=("model",)),
            c.plan_comm_bytes([c.AllGather("model", 0)], d((256, 256), {0: ("model",)}),
                              {"model": 16}, 2),
            c.plan_transfer_bytes([c.Transfer("model", 0)], d((256, 256), {0: ("model",)}),
                                  {"model": 16}, 2),
        ]
        with_partial = ns.spec.AxeSpec.sharded((64, 128), space, {0: ("data",)})
        out.append(with_partial.with_partial(("model",)).signature())
        return out

    same(facts)


def test_pspec_rejects_strided_device_placement_in_both():
    def facts(ns):
        L = mk(ns, ((2, 2, "data"), (32, 1, "m")))
        fn = r_pspec_of_layout if ns is REF else p_dtensor.pspec_of_layout
        return fn(L, (64,), {"data": 4})

    assert same(facts, raises=True).startswith("ValueError")


def test_port_pspec_entries_equal_partition_spec():
    for shape, placement, _ in SPECS[:6]:
        for mesh in MESHES[:2]:
            space = r_spec.PhysicalSpace.from_mesh_shape(mesh)
            try:
                s = r_spec.AxeSpec.sharded(shape, space, placement)
            except ValueError:
                continue
            want = r_pspec_of_layout(s.layout, shape, mesh)
            got = p_dtensor.pspec_of_layout(
                p_spec.AxeSpec.sharded(shape, p_spec.PhysicalSpace.from_mesh_shape(mesh),
                                       placement).layout, shape, mesh)
            assert isinstance(want, P) and tuple(want) == got
