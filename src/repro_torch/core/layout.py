"""Axe layout algebra (paper §2 + Appendices A–F).

An Axe layout ``L = (D, R, O)`` is a set-valued map from logical tensor
indices to coordinates in a named multi-axis physical space:

* ``D`` (shard) — ordered tuple of *iters* ``(extent, stride@axis)``.
  The logical index is unflattened lexicographically over the extents
  (first iter slowest, last fastest); each digit contributes
  ``digit * stride`` on its named axis.
* ``R`` (replica) — multiset of iters enumerating offsets independent of
  the logical index (replication / broadcast).
* ``O`` (offset) — constant per-axis offset.

``f_L(x) = { f_D(x) + f_R(r) + O | r in prod_t [0, e_t) }``

This module implements the full operator suite the paper's compiler
relies on:

* ``canonicalize``   — unique normal form (App. A: D0/D1 + C0/C1/C2)
* ``span``           — closed-form axiswise image extent (Lemma C.1)
* ``group``          — gcd-driven shape grouping (App. B, Alg. 1)
* ``tile``           — Kronecker composition ``A ⊗ B`` (App. C, Alg. 2)
* ``tile_of``        — decide ``A = C ⊗ B`` and recover ``C`` (App. D)
* ``slice``          — layout of an axis-aligned subregion (App. E)
* ``direct_sum``     — unscaled superposition ``A + B`` (App. F)

Strides are generalized to ``ZA`` vectors (integer combinations of named
axes); single-axis iters — the paper's presentation — are the common
case, and the symmetric one-wrap slice form (Lemma E.2) naturally
produces a two-axis iter.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

from repro_torch.core.za import ZA

Shape = Tuple[int, ...]


# ---------------------------------------------------------------------------
# Iter
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Iter:
    """A linear strided access: ``f_I(x) = x * stride`` for x in [0, extent).

    ``stride`` is a ZA vector; the paper's ``(e, s, a)`` is
    ``Iter(e, ZA.single(a, s))`` and can be built with ``It(e, s, a)``.
    """

    extent: int
    stride: ZA

    def __post_init__(self) -> None:
        if self.extent <= 0:
            raise ValueError(f"iter extent must be positive, got {self.extent}")
        if not isinstance(self.stride, ZA):
            raise TypeError("stride must be a ZA vector; use It(e, s, axis)")

    @property
    def axis(self) -> Optional[str]:
        return self.stride.single_axis()

    def __call__(self, x: int) -> ZA:
        return self.stride * x

    def __repr__(self) -> str:
        return f"({self.extent})·[{self.stride}]"


def It(extent: int, stride: int, axis: str = "m") -> Iter:
    """Paper-style iter constructor: ``It(8, 4, "lane")`` == (8, 4@lane)."""
    return Iter(extent, ZA.single(axis, stride))


# ---------------------------------------------------------------------------
# Layout
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Layout:
    """An Axe layout ``(D, R, O)``."""

    D: Tuple[Iter, ...]
    R: Tuple[Iter, ...] = ()
    O: ZA = ZA.zero

    def __post_init__(self) -> None:
        if not isinstance(self.D, tuple):
            object.__setattr__(self, "D", tuple(self.D))
        if not isinstance(self.R, tuple):
            object.__setattr__(self, "R", tuple(self.R))
        if len(self.D) < 1:
            # Permit the degenerate empty-D layout as a single-point map;
            # useful as an identity for composition.
            object.__setattr__(self, "D", (It(1, 1, "m"),))

    # -- size / admission ---------------------------------------------
    @property
    def size(self) -> int:
        return math.prod(i.extent for i in self.D)

    @property
    def replication_degree(self) -> int:
        return math.prod(i.extent for i in self.R)

    def admits(self, shape: Sequence[int]) -> bool:
        return math.prod(shape) == self.size

    # -- induced map ----------------------------------------------------
    def digits(self, x: int) -> Tuple[int, ...]:
        """Lexicographic unflattening of ``x`` over D's extents."""
        ds: List[int] = []
        for it in reversed(self.D):
            ds.append(x % it.extent)
            x //= it.extent
        return tuple(reversed(ds))

    def f_D(self, x: int) -> ZA:
        if not (0 <= x < self.size):
            raise IndexError(f"logical index {x} out of [0, {self.size})")
        acc = ZA.zero
        for it, d in zip(self.D, self.digits(x)):
            acc = acc + it(d)
        return acc

    def f_R(self) -> List[ZA]:
        """All replication offsets (the fiber of the set-valued map)."""
        out = [ZA.zero]
        for it in self.R:
            out = [base + it(r) for base in out for r in range(it.extent)]
        return out

    def __call__(self, x: int) -> FrozenSet[ZA]:
        base = self.f_D(x) + self.O
        return frozenset(base + r for r in self.f_R())

    def call_shaped(self, index: Sequence[int], shape: Sequence[int]) -> FrozenSet[ZA]:
        """``f_{L<S>}(u)``: row-major flatten ``index`` w.r.t. ``shape``."""
        if not self.admits(shape):
            raise ValueError(f"shape {tuple(shape)} not admitted by layout of size {self.size}")
        flat = 0
        for i, s in zip(index, shape):
            if not (0 <= i < s):
                raise IndexError(f"index {tuple(index)} out of shape {tuple(shape)}")
            flat = flat * s + i
        return self(flat)

    # -- axes / span -----------------------------------------------------
    def axes(self) -> Tuple[str, ...]:
        seen: Dict[str, None] = {}
        for it in self.D + self.R:
            for a in it.stride.axes():
                seen.setdefault(a)
        for a in self.O.axes():
            seen.setdefault(a)
        return tuple(seen)

    def span(self) -> Dict[str, int]:
        """Axiswise span (Lemma C.1): 1 + sum |s|(e-1) over D and R.

        The offset O shifts min and max identically so it does not
        contribute. Axes not touched have span 1 (by convention).
        """
        spans: Dict[str, int] = {}
        for it in self.D + self.R:
            for a, s in it.stride.items():
                spans[a] = spans.get(a, 0) + abs(s) * (it.extent - 1)
        return {a: v + 1 for a, v in spans.items()}

    def span_axis(self, axis: str) -> int:
        return self.span().get(axis, 1)

    # -- brute force (tests / small layouts) ------------------------------
    def enumerate_map(self) -> List[FrozenSet[ZA]]:
        return [self(x) for x in range(self.size)]

    def all_coords(self) -> FrozenSet[ZA]:
        out = set()
        for x in range(self.size):
            out |= self(x)
        return frozenset(out)

    def equivalent_bruteforce(self, other: "Layout") -> bool:
        return self.size == other.size and self.enumerate_map() == other.enumerate_map()

    # -- operator suite (delegates) ---------------------------------------
    def canonicalize(self) -> "Layout":
        return canonicalize(self)

    def group(self, shape: Sequence[int]) -> "GroupedLayout":
        return group(self, shape)

    def slice(self, starts: Sequence[int], sizes: Sequence[int], shape: Sequence[int]) -> "Layout":
        return slice_layout(self, starts, sizes, shape)

    def __repr__(self) -> str:
        d = ", ".join(repr(i) for i in self.D)
        parts = [f"D({d})"]
        if self.R:
            parts.append("R[" + ", ".join(repr(i) for i in self.R) + "]")
        if not self.O.is_zero:
            parts.append(f"O<{self.O}>")
        return "Axe{" + " ".join(parts) + "}"


# ---------------------------------------------------------------------------
# Convenience constructors
# ---------------------------------------------------------------------------


def from_shape(shape: Sequence[int], axis: str = "m", base_stride: int = 1) -> Layout:
    """Row-major dense layout of ``shape`` on a single axis."""
    iters: List[Iter] = []
    stride = base_stride
    for e in reversed(shape):
        iters.append(It(e, stride, axis))
        stride *= e
    return Layout(tuple(reversed(iters)))


def strided(shape: Sequence[int], strides: Sequence[int], axis: str = "m") -> Layout:
    return Layout(tuple(It(e, s, axis) for e, s in zip(shape, strides)))


# ---------------------------------------------------------------------------
# Canonicalization (Appendix A)
# ---------------------------------------------------------------------------


def _canon_D(D: Sequence[Iter]) -> Tuple[Iter, ...]:
    """D0 (drop extent-1) + D1 (merge chained same-axis adjacents)."""
    out: List[Iter] = [it for it in D if it.extent != 1]
    changed = True
    while changed:
        changed = False
        i = 0
        while i + 1 < len(out):
            a, b = out[i], out[i + 1]
            # D1: s_i == e_{i+1} * s_{i+1} (vector equality)
            if a.stride == b.stride * b.extent:
                out[i : i + 2] = [Iter(a.extent * b.extent, b.stride)]
                changed = True
            else:
                i += 1
    return tuple(out)


def _canon_RO(R: Sequence[Iter], O: ZA) -> Tuple[Tuple[Iter, ...], ZA]:
    """C0 (drop units) + C1 (sign-normalize) + C2 (absorb multiples).

    Only single-axis replication iters participate in C2 merging;
    vector-stride iters (rare) are kept as-is after C0/C1.
    """
    work: List[Iter] = []
    for it in R:
        if it.extent == 1 or it.stride.is_zero:
            continue  # C0
        work.append(it)

    # C1: flip every negative component sign by pushing into O.
    normed: List[Iter] = []
    for it in work:
        stride = it.stride
        neg = ZA([(a, v) for a, v in stride.items() if v < 0])
        if not neg.is_zero:
            # iterating digit r with stride s<0 == stride -s with offset (e-1)*s
            O = O + neg * (it.extent - 1)
            stride = ZA([(a, abs(v)) for a, v in stride.items()])
        normed.append(Iter(it.extent, stride))

    # C2 per axis: absorb stride multiples. Applies to single-axis iters.
    by_axis: Dict[str, List[Iter]] = {}
    passthrough: List[Iter] = []
    for it in normed:
        ax = it.axis
        if ax is None:
            passthrough.append(it)
        else:
            by_axis.setdefault(ax, []).append(it)

    merged_all: List[Iter] = []
    for ax, iters in by_axis.items():
        items = sorted(((it.stride[ax], it.extent) for it in iters))
        changed = True
        while changed:
            changed = False
            items.sort()
            for i in range(len(items)):
                s_i, e_i = items[i]
                for j in range(len(items)):
                    if i == j:
                        continue
                    s_j, e_j = items[j]
                    if s_j % s_i == 0:
                        q = s_j // s_i
                        if 1 <= q <= e_i:
                            items[i] = (s_i, e_i + q * (e_j - 1))
                            del items[j]
                            changed = True
                            break
                if changed:
                    break
        merged_all.extend(It(e, s, ax) for s, e in items if e > 1)

    merged_all.extend(passthrough)
    merged_all.sort(key=lambda it: (sorted(it.stride.items()), it.extent))
    return tuple(merged_all), O


def canonicalize(L: Layout) -> Layout:
    D = _canon_D(L.D)
    if not D:
        D = (It(1, 1, "m"),)
    R, O = _canon_RO(L.R, L.O)
    return Layout(D, R, O)


def layouts_equal(a: Layout, b: Layout) -> bool:
    """Semantic equality via canonical forms (Thm. A.14, under GC)."""
    ca, cb = canonicalize(a), canonicalize(b)
    return ca.D == cb.D and sorted(ca.R, key=repr) == sorted(cb.R, key=repr) and ca.O == cb.O


def satisfies_gap_condition(L: Layout) -> bool:
    """Check the per-axis gap condition (GC) on R (App. A.1)."""
    by_axis: Dict[str, List[Tuple[int, int]]] = {}
    for it in L.R:
        ax = it.axis
        if ax is None:
            return False  # vector replication — out of GC scope
        by_axis.setdefault(ax, []).append((it.stride[ax], it.extent))
    for items in by_axis.values():
        items.sort()
        for (s1, e1), (s2, _e2) in zip(items, items[1:]):
            if s2 <= e1 * s1:
                return False
    return True


# ---------------------------------------------------------------------------
# Grouping (Appendix B, Algorithm 1)
# ---------------------------------------------------------------------------


class GroupingError(ValueError):
    pass


@dataclasses.dataclass(frozen=True)
class GroupedLayout:
    """A layout whose D-list is partitioned into rank blocks realizing
    a target shape: block i's extent product == shape[i]."""

    layout: Layout
    shape: Shape
    blocks: Tuple[Tuple[Iter, ...], ...]

    def block(self, i: int) -> Tuple[Iter, ...]:
        return self.blocks[i]


def group(L: Layout, shape: Sequence[int]) -> GroupedLayout:
    """gcd-driven canonical grouping (Alg. 1). Raises GroupingError."""
    shape = tuple(int(s) for s in shape)
    if math.prod(shape) != L.size:
        raise GroupingError(f"shape {shape} does not admit layout of size {L.size}")

    src: List[Iter] = [it for it in L.D if it.extent != 1]  # unit iters are no-ops
    j = 0
    blocks: List[Tuple[Iter, ...]] = []
    for target in shape:
        cur = 1
        blk: List[Iter] = []
        while cur < target:
            if j >= len(src):
                raise GroupingError("ran out of iters while grouping")
            it = src[j]
            rem = target // cur
            if target % cur:
                raise GroupingError("internal: non-divisible accumulation")
            g = math.gcd(it.extent, rem)
            if g == 1:
                raise GroupingError(
                    f"cannot split iter extent {it.extent} toward block target {target}"
                )
            e_head, e_tail = g, it.extent // g
            blk.append(Iter(e_head, it.stride * e_tail))
            cur *= e_head
            if e_tail > 1:
                src[j] = Iter(e_tail, it.stride)
            else:
                j += 1
        blocks.append(tuple(blk))
    if j != len(src):
        raise GroupingError("iters left over after grouping")
    flat = tuple(itertools.chain.from_iterable(blocks))
    return GroupedLayout(Layout(flat, L.R, L.O), shape, tuple(blocks))


# ---------------------------------------------------------------------------
# Tiling (Appendix C, Algorithm 2)
# ---------------------------------------------------------------------------


class TileError(ValueError):
    pass


def tile(A: Layout, S_A: Sequence[int], B: Layout, S_B: Sequence[int]) -> Tuple[Layout, Shape]:
    """Kronecker tile ``T = A_{||S_A} ⊗ B_{||S_B}``.

    Returns ``(T, S_T)`` where ``S_T`` is the interleaved shape
    ``(S_A[0], S_B[0], ..., S_A[r-1], S_B[r-1])``. ``T`` also admits the
    merged shape ``(S_A[0]*S_B[0], ...)`` where logical dim j indexes
    ``x_j * S_B[j] + y_j`` (outer-major), i.e. the classic block layout.
    """
    S_A, S_B = tuple(S_A), tuple(S_B)
    if len(S_A) != len(S_B):
        raise TileError("shape ranks must match")
    gA = group(A, S_A)
    gB = group(B, S_B)
    spans = gB.layout.span()  # includes R^B per Lemma C.1

    D_T: List[Iter] = []
    for blkA, blkB in zip(gA.blocks, gB.blocks):
        for it in blkA:
            D_T.append(Iter(it.extent, it.stride.scale_by(spans)))
        D_T.extend(blkB)
    R_T = tuple(Iter(it.extent, it.stride.scale_by(spans)) for it in A.R) + tuple(B.R)
    O_T = A.O.scale_by(spans) + B.O
    S_T = tuple(itertools.chain.from_iterable(zip(S_A, S_B)))
    return Layout(tuple(D_T), R_T, O_T), S_T


def tile_merged(A: Layout, S_A: Sequence[int], B: Layout, S_B: Sequence[int]) -> Tuple[Layout, Shape]:
    """Tile, returning the merged per-dim shape (S_A[j]*S_B[j])."""
    T, _ = tile(A, S_A, B, S_B)
    merged = tuple(a * b for a, b in zip(S_A, S_B))
    return T, merged


# ---------------------------------------------------------------------------
# Direct sum on the tiling domain (Appendix F)
# ---------------------------------------------------------------------------


def direct_sum(A: Layout, S_A: Sequence[int], B: Layout, S_B: Sequence[int]) -> Tuple[Layout, Shape]:
    """Unscaled superposition ``A + B`` over the interleaved domain."""
    S_A, S_B = tuple(S_A), tuple(S_B)
    if len(S_A) != len(S_B):
        raise TileError("shape ranks must match")
    gA = group(A, S_A)
    gB = group(B, S_B)
    D: List[Iter] = []
    for blkA, blkB in zip(gA.blocks, gB.blocks):
        D.extend(blkA)
        D.extend(blkB)
    S_T = tuple(itertools.chain.from_iterable(zip(S_A, S_B)))
    return Layout(tuple(D), tuple(A.R) + tuple(B.R), A.O + B.O), S_T


# ---------------------------------------------------------------------------
# Tile-of check and C recovery (Appendix D, Algorithm 3)
# ---------------------------------------------------------------------------


def tile_of(A: Layout, S_A: Sequence[int], B: Layout, S_B: Sequence[int]) -> Optional[Tuple[Layout, Shape]]:
    """Decide ``A = C ⊗ B`` and recover ``C`` (grouped by S_C); None if not."""
    S_A, S_B = tuple(S_A), tuple(S_B)
    if len(S_A) != len(S_B):
        return None
    for sa, sb in zip(S_A, S_B):
        if sa % sb:
            return None
    S_C = tuple(sa // sb for sa, sb in zip(S_A, S_B))
    try:
        gA = group(canonicalize(A), S_A)
        gB = group(canonicalize(B), S_B)
    except GroupingError:
        return None
    spans = gB.layout.span()

    def _descale(it: Iter) -> Optional[Iter]:
        items = []
        for a, s in it.stride.items():
            w = spans.get(a, 1)
            if s % w:
                return None
            items.append((a, s // w))
        return Iter(it.extent, ZA(items))

    C_iters: List[Iter] = []
    for j, (blkA, blkB) in enumerate(zip(gA.blocks, gB.blocks)):
        # Within each rank block, B's iters form the fast suffix of the
        # interleave [scaled-C..., B...]; canonicalization may have merged
        # iters across that boundary, so scan backwards with a split rule.
        a_stack = list(blkA)
        b_stack = list(blkB)
        c_blk: List[Iter] = []
        while a_stack:
            it = a_stack.pop()
            if b_stack:
                bt = b_stack[-1]
                if it == bt:
                    b_stack.pop()
                    continue
                if it.stride == bt.stride and it.extent % bt.extent == 0 and it.extent > bt.extent:
                    # split: expose B's iter as the fast tail (Lemma B.1)
                    b_stack.pop()
                    a_stack.append(Iter(it.extent // bt.extent, it.stride * bt.extent))
                    continue
            d = _descale(it)
            if d is None:
                return None
            c_blk.insert(0, d)
        if b_stack:
            return None
        if math.prod(i.extent for i in c_blk) != S_C[j]:
            return None
        C_iters.extend(c_blk)

    # offsets: O_A == O_C ⊙ W + O_B
    o_items = []
    diff = A.O - B.O
    for a, v in diff.items():
        w = spans.get(a, 1)
        if v % w:
            return None
        o_items.append((a, v // w))
    O_C = ZA(o_items)

    # replication: match R_B as a sub-multiset of R_A; rest must descale.
    ra = list(canonicalize(Layout(A.D, A.R, ZA.zero)).R)
    rb = list(canonicalize(Layout(B.D, B.R, ZA.zero)).R)
    R_C: List[Iter] = []
    for it in rb:
        if it in ra:
            ra.remove(it)
        else:
            return None
    for it in ra:
        desc_items = []
        for a, s in it.stride.items():
            w = spans.get(a, 1)
            if s % w:
                return None
            desc_items.append((a, s // w))
        R_C.append(Iter(it.extent, ZA(desc_items)))

    if not C_iters:
        C_iters = [It(1, 1, "m")]
    return Layout(tuple(C_iters), tuple(R_C), O_C), S_C


# ---------------------------------------------------------------------------
# Slicing (Appendix E, Algorithm 4)
# ---------------------------------------------------------------------------


class SliceError(ValueError):
    pass


def _slice_block(block: Sequence[Iter], b: int, T: int) -> List[Iter]:
    """Slice one grouped block over region [b, b+T); offset handled by
    the caller (absorbed into the region-origin address O*)."""
    m = len(block)
    extent = math.prod(i.extent for i in block)
    if not (0 <= b and b + T <= extent):
        raise SliceError(f"region [{b},{b + T}) out of block extent {extent}")
    if T == extent and b == 0:
        return list(block)

    # start digits
    d0: List[int] = []
    x = b
    for it in reversed(block):
        d0.append(x % it.extent)
        x //= it.extent
    d0.reverse()

    peeled: List[Iter] = []
    rem = T
    k = -1
    for j in range(m - 1, -1, -1):
        e_j = block[j].extent
        if d0[j] == 0 and rem % e_j == 0:
            peeled.insert(0, block[j])
            rem //= e_j
        else:
            k = j
            break
    if rem == 1:
        return peeled

    e_k = block[k].extent
    s_k = block[k].stride
    if d0[k] + rem <= e_k:
        # no-wrap (Lemma E.1)
        return [Iter(rem, s_k)] + peeled
    if rem % 2 == 0 and d0[k] + rem // 2 == e_k and (k == 0 or d0[k - 1] + 1 < block[k - 1].extent):
        # symmetric one-wrap (Lemma E.2). DEVIATION from the paper: its
        # capacity condition "d_{k-1}+1 <= E_{k-1}" admits d+1 == E, where
        # the carry overflows digit k-1 and propagates left — the 2-iter
        # form is then wrong (found by property testing: slice [5,11) of
        # extents (2,2,4), unit strides). We require strict inequality.
        c = rem // 2
        delta = -(s_k * (e_k - c))
        if k > 0:
            delta = block[k - 1].stride + delta
        return [Iter(2, delta), Iter(c, s_k)] + peeled
    raise SliceError(
        f"block not sliceable on [{b},{b + T}): pivot digit {d0[k]} extent {e_k}"
    )


def slice_layout(L: Layout, starts: Sequence[int], sizes: Sequence[int], shape: Sequence[int]) -> Layout:
    """``L[R:S]`` — the layout of subregion ``starts:starts+sizes`` of a
    tensor with logical shape ``shape`` laid out by ``L``.

    Satisfies ``f_{L[R:S]<T>}(u) == f_{L<S>}(u + starts)``.
    """
    shape = tuple(shape)
    starts = tuple(starts)
    sizes = tuple(sizes)
    if len(starts) != len(shape) or len(sizes) != len(shape):
        raise SliceError("rank mismatch")
    g = group(L, shape)

    # region-origin address O* (D part at starts + original O)
    flat = 0
    for i, s in zip(starts, shape):
        flat = flat * s + i
    O_star = g.layout.f_D(flat) + L.O

    D_out: List[Iter] = []
    for blk, b, t in zip(g.blocks, starts, sizes):
        D_out.extend(_slice_block(blk, b, t))
    if not D_out:
        D_out = [It(1, 1, next(iter(L.axes()), "m"))]
    return Layout(tuple(D_out), L.R, O_star)
