"""Device meshes on ``torch.distributed`` — the port of
``repro/launch/mesh.py`` — and the hardware constants of the card the
port prices its layouts for.

A :class:`Mesh` is built inside an initialised ``torch.distributed``
world of ``prod(shape)`` ranks. Rank ``r`` sits at the row-major
coordinates of ``r`` in ``shape``, as a JAX mesh orders its devices,
and holds one process group per set of axes: the ranks that differ from
it only along those axes. Every rank creates every group, in the same
order (a ``new_group`` that one rank misses hangs the world). The
mesh is also the context its collectives run in (``with mesh:``,
``core.collective.use_mesh``).

The backend rule (:func:`backend_rule`) is explicit and printed: NCCL
only when every rank has a card of its own, gloo when the ranks run on
the CPU or share a card. Under gloo, CUDA tensors are staged through
the host by ``core.collective``'s transport, and counted.

:func:`make_mesh` and :func:`make_local_mesh` take the world from the
environment when none is initialised (``python -m torch.distributed.run
--nproc-per-node N ...`` sets it); :func:`spawn` starts a world of its
own: it runs ``fn(mesh)`` in ``prod(shape)`` processes over a
``FileStore``, stops every rank when one fails, and returns each rank's
value.

:func:`production_geometry` is the reference's production mesh
(``make_production_mesh``), ``(16, 16)`` over ``("data", "model")`` or
``(2, 16, 16)`` over ``("pod", "data", "model")``. No one world of 256 or
512 ranks runs here: :meth:`Mesh.deviceless` (of that shape or any other)
is one rank's view of such a world with no ``torch.distributed`` world
and no card behind it. Its tensors live on ``meta``; it has the coordinates,
group ranks and chunk orders of a real mesh of that shape and no process
groups, and ``core.collective``'s transport gives each collective's
outputs their shapes and counts it as a real world would, moving
nothing (``launch/dryrun.py``'s ``lower_cell`` runs one rank's step so).

The constants below are datasheet figures (NVIDIA's H100 data sheet,
SXM part, dense rates without sparsity, at the full 700 W limit), not
measurements; a card set below 700 W runs slower under load. They feed
the solver's roofline through ``axe.hetero.default_class_table``. The
JAX package's TPU constants do not apply to the port.
"""
from __future__ import annotations

import datetime
import math
import os
import pickle
import queue as queue_mod
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

#: the card these constants describe, and its rated power limit
DEVICE_NAME = "NVIDIA H100 SXM 80GB"
POWER_LIMIT_W = 700.0

PEAK_FLOPS_BF16 = 989e12      # FLOP/s, dense bf16 tensor cores
HBM_BW = 3.35e12              # B/s, HBM3
NVLINK_BW = 450e9             # B/s, NVLink 4, each direction per card
HBM_BYTES = 80 * 1024**3      # 80 GiB

#: the longest any collective of a world waits before it fails
WORLD_TIMEOUT_S = 120


def backend_rule(device: Union[str, torch.device], world: int) -> Tuple[str, str]:
    """``(backend, why)`` for a world of ``world`` ranks on ``device``:
    NCCL only when every rank has a card of its own, else gloo."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "gloo", f"{world} ranks on the CPU"
    cards = torch.cuda.device_count()
    if world <= cards:
        return "nccl", f"{world} ranks, each on a card of its own ({cards} cards)"
    return "gloo", (f"{world} ranks share {cards} card(s): NCCL runs no two ranks of one "
                    f"communicator on one card; CUDA tensors are staged through the host")


def _rank_device(device, local_rank: int) -> torch.device:
    from repro_torch.core.device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    return dev


class Mesh:
    """This rank's view of a device mesh over the initialised world (or,
    :meth:`deviceless`, over none)."""

    #: True for a :meth:`deviceless` mesh: no world, no groups, ``meta`` tensors
    is_deviceless = False

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str], *,
                 device: Optional[Union[str, torch.device]] = None):
        import torch.distributed as dist

        self._axes(shape, axis_names)
        if not dist.is_initialized():
            raise RuntimeError("Mesh needs an initialised torch.distributed world "
                               "(make_mesh / make_local_mesh / spawn start one)")
        self.world = dist.get_world_size()
        if self.world != math.prod(self.shape):
            raise ValueError(f"mesh {dict(zip(self.axis_names, self.shape))} needs "
                             f"{math.prod(self.shape)} ranks, the world has {self.world}")
        self.rank = dist.get_rank()
        self.backend = dist.get_backend()
        self.device = _rank_device(device, int(os.environ.get("LOCAL_RANK", self.rank)))
        want, _ = backend_rule(self.device, self.world)
        if self.backend != want:
            raise RuntimeError(f"the world runs {self.backend}, the backend rule asks "
                               f"{want} for {self.world} ranks on {self.device.type}")
        self._place(self.rank)
        n = len(self.axis_names)
        subsets = [tuple(i for i in range(n) if mask >> i & 1) for mask in range(1, 1 << n)]
        for dims in sorted(subsets, key=lambda d: (len(d), d)):
            # every rank creates every group of every set of axes, in one
            # order; a group's ranks run in mesh order
            size = math.prod(self.shape[i] for i in dims)
            lines = np.moveaxis(self.devices, dims, list(range(n - len(dims), n))).reshape(-1, size)
            key = tuple(self.axis_names[i] for i in dims)
            for line in lines:
                ranks = tuple(int(r) for r in line)
                g = dist.new_group(list(ranks))
                if self.rank in ranks:
                    self._groups[key], self._group_ranks[key] = g, ranks

    def _axes(self, shape, axis_names) -> None:
        self.shape = tuple(int(s) for s in shape)
        self.axis_names = tuple(axis_names)
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.shape} vs axes {self.axis_names}")

    def _place(self, rank: int) -> None:
        self.rank = rank
        #: global ranks in mesh order, like a JAX mesh's ``devices`` array
        self.devices = np.arange(math.prod(self.shape)).reshape(self.shape)
        self.coords = dict(zip(self.axis_names,
                               (int(c) for c in np.unravel_index(self.rank, self.shape))))
        self._groups: Dict[Tuple[str, ...], Any] = {}
        self._group_ranks: Dict[Tuple[str, ...], Tuple[int, ...]] = {}
        self._tag = 0
        self._chunk_orders: Dict[Tuple[str, ...], List[int]] = {}

    @classmethod
    def deviceless(cls, shape: Sequence[int], axis_names: Sequence[str], *,
                   rank: int = 0) -> "Mesh":
        """Rank ``rank``'s view of a ``shape`` mesh with no world behind
        it: no ``torch.distributed``, no process group, no card. Its
        device is ``meta``; :meth:`group_ranks` and :meth:`chunk_order`
        are a real mesh's; :meth:`group` is None and
        :meth:`all_ranks_agree` checks nothing."""
        self = cls.__new__(cls)
        self._axes(shape, axis_names)
        self.world = math.prod(self.shape)
        if not 0 <= rank < self.world:
            raise ValueError(f"rank {rank} of a {self.world}-rank mesh")
        self.backend, self.device, self.is_deviceless = None, torch.device("meta"), True
        self._place(rank)
        return self

    @property
    def mesh_shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.shape))

    def axes_of(self, axes: Union[str, Sequence[str]]) -> Tuple[str, ...]:
        """``axes`` (one axis name or several) as a tuple, checked."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        unknown = [a for a in axes if a not in self.axis_names]
        if unknown or len(set(axes)) != len(axes):
            raise ValueError(f"axes {axes} on a mesh of {self.axis_names}")
        return axes

    def axis_size(self, axes: Union[str, Sequence[str]]) -> int:
        """Ranks along one axis, or along several together."""
        return math.prod(self.mesh_shape[a] for a in self.axes_of(axes))

    def axis_index(self, axes: Union[str, Sequence[str]]) -> int:
        """This rank's coordinate along one axis, or along several taken
        together, the first of them major."""
        idx = 0
        for a in self.axes_of(axes):
            idx = idx * self.mesh_shape[a] + self.coords[a]
        return idx

    def _key(self, axes) -> Tuple[str, ...]:
        axes = set(self.axes_of(axes))
        return tuple(a for a in self.axis_names if a in axes)

    def group(self, axes: Union[str, Sequence[str]]):
        """This rank's process group along one axis, or along several
        (the ranks that differ from it only along those axes); None on a
        deviceless mesh."""
        return None if self.is_deviceless else self._groups[self._key(axes)]

    def group_ranks(self, axes: Union[str, Sequence[str]]) -> Tuple[int, ...]:
        """The global ranks of :meth:`group`, in mesh order (for one axis:
        in axis order)."""
        key = self._key(axes)
        if key not in self._group_ranks:
            line = self.devices[tuple(slice(None) if a in key else self.coords[a]
                                      for a in self.axis_names)]
            self._group_ranks[key] = tuple(int(r) for r in line.reshape(-1))
        return self._group_ranks[key]

    def chunk_order(self, axes: Union[str, Sequence[str]]) -> List[int]:
        """For each rank of :meth:`group`, in its order, the index of the
        chunk it holds of a dim that ``axes`` shard (``axes[0]`` major):
        the identity when ``axes`` run in mesh order."""
        axes = self.axes_of(axes)
        if axes in self._chunk_orders:
            return self._chunk_orders[axes]
        out = self._chunk_orders[axes] = []
        for r in self.group_ranks(axes):
            coords = np.unravel_index(r, self.shape)
            idx = 0
            for a in axes:
                idx = idx * self.mesh_shape[a] + int(coords[self.axis_names.index(a)])
            out.append(idx)
        return out

    def next_tag(self) -> int:
        """A point-to-point tag: every rank draws them in one order."""
        self._tag += 1
        return self._tag

    def all_ranks_agree(self, value: int, what: str) -> None:
        """Raise on every rank unless all ranks hold the same ``value``
        (one all-gather over the world). A deviceless mesh has no other
        rank to ask."""
        import torch.distributed as dist

        if self.is_deviceless:
            return
        dev = self.device if self.backend == "nccl" else torch.device("cpu")
        mine = torch.tensor([value], dtype=torch.int64, device=dev)
        every = [torch.empty_like(mine) for _ in range(self.world)]
        dist.all_gather(every, mine)
        values = [int(t.item()) for t in every]
        if len(set(values)) > 1:
            odd = [r for r, v in enumerate(values) if v != values[0]]
            raise RuntimeError(f"the ranks disagree on {what} (ranks {odd} differ from rank 0); "
                               f"they would deadlock in mismatched collectives")

    def __enter__(self):
        from repro_torch.core import collective

        self._ctx = collective.use_mesh(self)
        return self._ctx.__enter__()

    def __exit__(self, *exc):
        return self._ctx.__exit__(*exc)

    def __repr__(self) -> str:
        how = "deviceless" if self.is_deviceless else self.backend
        return f"Mesh({self.mesh_shape}, rank {self.rank} at {self.coords}, {how} on {self.device})"


def production_geometry(multi_pod: bool = False) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """The reference's production mesh, ``(shape, axis_names)``: ``(16,
    16)`` over ``("data", "model")``, or ``(2, 16, 16)`` over ``("pod",
    "data", "model")``. ``Mesh.deviceless(*production_geometry(m))`` is
    one rank's view of it."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def init_world(device=None, *, timeout_s: float = WORLD_TIMEOUT_S) -> Tuple[str, str]:
    """Initialise ``torch.distributed`` from the environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, as
    ``torch.distributed.run`` sets them) under :func:`backend_rule`;
    returns ``(backend, why)``. A world already initialised is kept."""
    import torch.distributed as dist

    world = int(os.environ.get("WORLD_SIZE", "1"))
    dev = _rank_device(device, int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", "0"))))
    backend, why = backend_rule(dev, world)
    if not dist.is_initialized():
        if "MASTER_ADDR" not in os.environ and world == 1:
            os.environ.setdefault("MASTER_ADDR", "localhost")
            os.environ.setdefault("MASTER_PORT", "29512")
            os.environ.setdefault("RANK", "0")
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method="env://",
                                timeout=datetime.timedelta(seconds=timeout_s))
        if dist.get_rank() == 0:
            print(f"mesh backend: {backend} ({why})", flush=True)
    return backend, why


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], *, device=None) -> Mesh:
    """The mesh ``shape`` over ``axes`` on the initialised world (or the
    world the environment describes)."""
    import torch.distributed as dist

    if not dist.is_initialized():
        init_world(device)
    return Mesh(shape, axes, device=device)


def make_local_mesh(model: int = 1, *, device=None) -> Mesh:
    """A ``(world // model, model)`` ``("data", "model")`` mesh over the
    whole world (tests / examples)."""
    import torch.distributed as dist

    if not dist.is_initialized():
        init_world(device)
    n = dist.get_world_size()
    if n % model:
        raise ValueError(f"{n} ranks do not split into model={model}")
    return make_mesh((n // model, model), ("data", "model"), device=device)


# ---------------------------------------------------------------------------
# spawn: a world of local processes
# ---------------------------------------------------------------------------


def _orphan_watch(parent: int) -> None:
    """End this rank when the process that started it is gone (a crashed
    parent must not leave ranks waiting in a collective)."""
    import threading

    def watch():
        while os.getppid() == parent:
            time.sleep(1.0)
        os._exit(1)

    threading.Thread(target=watch, daemon=True).start()


def _rank_main(call_path, rank, world, store_path, shape, axes, device, results, timeout_s):
    import torch.distributed as dist

    _orphan_watch(os.getppid())
    try:
        with open(call_path, "rb") as f:  # written by this world's parent
            fn, args = pickle.load(f)
        torch.set_num_threads(1)
        # the loopback interface: a local world needs no network
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        os.environ["LOCAL_RANK"] = str(rank)
        dev = _rank_device(device, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        backend, _ = backend_rule(dev, world)
        dist.init_process_group(
            backend, store=dist.FileStore(store_path, world), rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=min(timeout_s, WORLD_TIMEOUT_S)))
        try:
            mesh = Mesh(shape, axes, device=dev)
            with mesh:
                out = fn(mesh, *args)
            results.put((rank, "ok", out))
        finally:
            dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 - every failure goes to the parent
        results.put((rank, "error", traceback.format_exc()))


class RankError(RuntimeError):
    """A rank of a :func:`spawn` world failed; the message holds its
    traceback."""


class World:
    """A world of local rank processes in flight (:func:`start`): the
    ranks run while the caller does other work; :meth:`join` collects
    them."""

    def __init__(self, fn: Callable, shape: Sequence[int], axes: Sequence[str], *,
                 device=None, timeout_s: float = 300.0, args: Sequence[Any] = (),
                 verbose: bool = True):
        import multiprocessing as mp

        self.size = math.prod(int(s) for s in shape)
        dev = _rank_device(device, 0)
        backend, why = backend_rule(dev, self.size)
        if verbose:
            print(f"mesh backend: {backend} ({why})", flush=True)
        if dev.type == "cuda":
            from repro_torch.kernels import _build

            _build.build_all()
        ctx = mp.get_context("spawn")
        self._results = ctx.Queue()
        self._tmp = tempfile.mkdtemp(prefix="repro_torch_world_")
        store = os.path.join(self._tmp, "store")
        # the function and its arguments go to the ranks through one file:
        # through each process's start pipe, a large argument would start
        # the ranks one after another, each at the pace of its imports
        call = os.path.join(self._tmp, "call.pkl")
        with open(call, "wb") as f:
            pickle.dump((fn, tuple(args)), f)
        self._procs = [ctx.Process(target=_rank_main, daemon=True,
                                   args=(call, r, self.size, store, tuple(shape), tuple(axes),
                                         device, self._results, timeout_s))
                       for r in range(self.size)]
        self._timeout_s = timeout_s
        self._deadline = time.monotonic() + timeout_s
        for p in self._procs:
            p.start()

    def join(self) -> List[Any]:
        """The ranks' values in rank order; the first rank that fails
        stops every rank and its traceback is raised (:class:`RankError`),
        as is a world that outlives its time limit."""
        out: Dict[int, Any] = {}
        try:
            while len(out) < self.size:
                try:
                    rank, status, value = self._results.get(timeout=1.0)
                except queue_mod.Empty:
                    dead = [(r, p.exitcode) for r, p in enumerate(self._procs)
                            if p.exitcode not in (None, 0) and r not in out]
                    if dead:
                        raise RankError(f"rank {dead[0][0]} exited with code {dead[0][1]} "
                                        f"before it reported")
                    if time.monotonic() > self._deadline:
                        raise RankError(f"the {self.size}-rank world outlived "
                                        f"{self._timeout_s:.0f} s (ranks done: {sorted(out)})")
                    continue
                if status == "error":
                    raise RankError(f"rank {rank} of {self.size} failed:\n{value}")
                out[rank] = value
        finally:
            self.stop(grace_s=10 if len(out) == self.size else 0.1)
        return [out[r] for r in range(self.size)]

    def stop(self, grace_s: float = 0.1) -> None:
        """End every rank (each gets ``grace_s`` to exit by itself) and
        remove the world's files."""
        import shutil

        for p in self._procs:
            p.join(timeout=grace_s)
        for p in self._procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(self._tmp, ignore_errors=True)


def start(fn: Callable, shape: Sequence[int], axes: Sequence[str], **kw) -> World:
    """:func:`spawn` without the wait: the ranks start and run while the
    caller goes on; ``.join()`` returns their values."""
    return World(fn, shape, axes, **kw)


def spawn(fn: Callable, shape: Sequence[int], axes: Sequence[str], *, device=None,
          timeout_s: float = 300.0, args: Sequence[Any] = (), verbose: bool = True) -> List[Any]:
    """Run ``fn(mesh, *args)`` on every rank of a fresh ``prod(shape)``-rank
    world (one process each, ``spawn`` start method, over a ``FileStore``
    in a temporary directory: no ports). ``fn`` must be importable by
    name (a module-level function) and return something picklable.
    Each rank runs one torch thread. The kernels are built here, before
    the ranks start, so no two ranks race an ``nvcc``. Returns the ranks'
    values in rank order; the first rank that fails stops every rank and
    its traceback is raised (:class:`RankError`), as is a world that
    outlives ``timeout_s``."""
    return World(fn, shape, axes, device=device, timeout_s=timeout_s, args=args,
                 verbose=verbose).join()
