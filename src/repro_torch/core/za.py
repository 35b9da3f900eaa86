"""ZA — the free abelian group over named axes (paper §2.3).

An element of ``ZA`` is a formal sum ``sum_i z_i @ a_i`` with integer
coefficients over named hardware axes (``m``, ``lane``, ``data``,
``model``, ...).  It supports componentwise addition, scalar
multiplication and the Hadamard (axiswise) product used by the tile
operator.  Zero coefficients are never stored, so structural equality
coincides with mathematical equality.
"""
from __future__ import annotations

from typing import Dict, Iterable, Mapping, Tuple


class ZA:
    """Immutable sparse integer vector over named axes."""

    __slots__ = ("_items",)

    def __init__(self, items: Mapping[str, int] | Iterable[Tuple[str, int]] = ()):
        if isinstance(items, Mapping):
            pairs = items.items()
        else:
            pairs = items
        acc: Dict[str, int] = {}
        for axis, val in pairs:
            if not isinstance(axis, str):
                raise TypeError(f"axis must be str, got {axis!r}")
            v = acc.get(axis, 0) + int(val)
            if v:
                acc[axis] = v
            elif axis in acc:
                del acc[axis]
        self._items: Tuple[Tuple[str, int], ...] = tuple(sorted(acc.items()))

    # -- constructors -------------------------------------------------
    @staticmethod
    def of(**kwargs: int) -> "ZA":
        return ZA(kwargs)

    @staticmethod
    def single(axis: str, val: int) -> "ZA":
        return ZA(((axis, val),))

    zero: "ZA"  # set below

    # -- accessors ----------------------------------------------------
    def __getitem__(self, axis: str) -> int:
        for a, v in self._items:
            if a == axis:
                return v
        return 0

    def axes(self) -> Tuple[str, ...]:
        return tuple(a for a, _ in self._items)

    def items(self) -> Tuple[Tuple[str, int], ...]:
        return self._items

    def to_dict(self) -> Dict[str, int]:
        return dict(self._items)

    @property
    def is_zero(self) -> bool:
        return not self._items

    def single_axis(self) -> str | None:
        """The axis name if exactly one axis has a nonzero coefficient."""
        if len(self._items) == 1:
            return self._items[0][0]
        return None

    # -- algebra ------------------------------------------------------
    def __add__(self, other: "ZA") -> "ZA":
        return ZA(list(self._items) + list(other._items))

    def __sub__(self, other: "ZA") -> "ZA":
        return ZA(list(self._items) + [(a, -v) for a, v in other._items])

    def __neg__(self) -> "ZA":
        return ZA([(a, -v) for a, v in self._items])

    def __mul__(self, k: int) -> "ZA":
        if k == 0:
            return ZA()
        return ZA([(a, v * k) for a, v in self._items])

    __rmul__ = __mul__

    def hadamard(self, other: "ZA") -> "ZA":
        """Axiswise product (paper: ⊙)."""
        return ZA([(a, v * other[a]) for a, v in self._items])

    def scale_by(self, spans: Mapping[str, int]) -> "ZA":
        """Multiply each axis coefficient by ``spans.get(axis, 1)``."""
        return ZA([(a, v * int(spans.get(a, 1))) for a, v in self._items])

    def abs(self) -> "ZA":
        return ZA([(a, abs(v)) for a, v in self._items])

    # -- dunder -------------------------------------------------------
    def __eq__(self, other: object) -> bool:
        return isinstance(other, ZA) and self._items == other._items

    def __hash__(self) -> int:
        return hash(self._items)

    def __repr__(self) -> str:
        if not self._items:
            return "0"
        return " + ".join(f"{v}@{a}" for a, v in self._items)


ZA.zero = ZA()


def za(**kwargs: int) -> ZA:
    """Shorthand constructor: ``za(m=3, lane=1)`` == ``3@m + 1@lane``."""
    return ZA(kwargs)
