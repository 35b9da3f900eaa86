"""``core.collective.infer_redistribution`` on every pair of 2-D
placements of a ``(2, 4)`` ``("data", "model")`` mesh (each dim whole, on
one axis, or on both in either order): on 8 gloo ranks each plan, run
step by step, lands each rank on its block of the destination, bit for
bit.

Axes composed on one dim nest major→minor, and a tiled collective acts
on the minor-most axis of its dim. The JAX package's planner emits a
lone gather or all-to-all of an axis that has an axis minor to it left
behind (``(None, ("data", "model")) -> (None, "model")`` gathers
``data`` alone), whose result interleaves chunks out of mesh order; the
port's plan is the reference's wherever the reference's lands
(``collective._lands``), and gathers every axis and slices the
destination's where it does not (``ROADMAP.md`` §C)."""
import dataclasses
import itertools

from repro.core import collective as r_coll
from repro.core.dtensor import DTensorSpec as RSpec

import torch_mesh_ranks
from repro_torch.core import collective as p_coll
from repro_torch.core.dtensor import DTensorSpec as PSpec
from repro_torch.launch.mesh import spawn

MESH = {"data": 2, "model": 4}
SHAPE = (16, 32)
ENTRIES = (None, "data", "model", ("data", "model"), ("model", "data"))


def _axes(entry):
    return () if entry is None else (entry,) if isinstance(entry, str) else entry


PSPECS = [(a, b) for a, b in itertools.product(ENTRIES, ENTRIES)
          if not set(_axes(a)) & set(_axes(b))]
PAIRS = list(itertools.product(PSPECS, PSPECS))


def _placement(pspec):
    return [tuple(_axes(e)) for e in pspec]


def test_every_placement_pair_lands_on_the_destination_block():
    repaired, ref_plans = set(), []
    for src, dst in PAIRS:
        ref = r_coll.infer_redistribution(RSpec.from_pspec(SHAPE, src, MESH, "float32"),
                                          RSpec.from_pspec(SHAPE, dst, MESH, "float32"), MESH)
        got = p_coll.infer_redistribution(PSpec.from_pspec(SHAPE, src, MESH, "float32"),
                                          PSpec.from_pspec(SHAPE, dst, MESH, "float32"), MESH)
        ref_plans.append([(type(s).__name__, dataclasses.astuple(s)) for s in ref])
        ref = [getattr(p_coll, name)(*fields) for name, fields in ref_plans[-1]]
        if p_coll._lands(_placement(src), ref, _placement(dst)):
            assert [repr(s) for s in got] == [repr(s) for s in ref], (src, dst)
        else:
            repaired.add((src, dst))
            assert p_coll._lands(_placement(src), got, _placement(dst)), (src, dst)
    assert repaired
    ranks = spawn(torch_mesh_ranks.redistribution_world, tuple(MESH.values()), tuple(MESH),
                  device="cpu", args=(PAIRS, SHAPE, ref_plans))
    for r in ranks:
        assert r["port"] == [], r["port"][:8]
    # the reference's plans miss a block on some rank exactly where they do not land
    assert set().union(*[set(map(tuple, r["ref"])) for r in ranks]) == repaired
