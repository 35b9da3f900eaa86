"""Checkpointing with atomic commit (``repro/checkpoint/manager.py``),
in the JAX package's on-disk format, byte for byte:

    <dir>/step_00000123.tmp/...   (in flight)
    <dir>/step_00000123/          (committed by an atomic rename)
        manifest.json             (step; each leaf's path, file, dtype, shape)
        <leaf-path>.npy           (one file per leaf, the full array)

Leaves are named by the reference's path rule (``core.tree``: dict keys
sorted, NamedTuple fields by name, ``/``-joined; ``__`` in the file
name). bf16 has no numpy dtype: it is stored as its uint16 bits with
the ``"bfloat16"`` tag and crosses back as those bits, so no
``ml_dtypes`` is needed. So either package restores what the other
wrote, given a template of the same leaves and shapes. A failed or
partial save is invisible (its ``.tmp`` directory is never renamed);
``keep`` bounds the committed steps kept; ``async_save`` copies the state
to the host and writes it on a thread.

Restore puts each leaf on its template leaf's device. On a device mesh
both take ``shardings``, a tree of ``core.dtensor.NamedSharding`` (None
for a leaf every rank holds whole) beside a state of the rank's shards:
``save`` gathers leaf by leaf and one rank writes the full leaves, the
same files and manifest; ``restore`` gives each rank its shard of each
leaf, read from the file's mapped pages (the reference's ``device_put``
with ``shardings``), so a world of another mesh resumes from it.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.tree import leaves_with_paths, unflatten


def _named_leaves(tree: Any) -> List[Tuple[str, Any]]:
    """``(path, leaf)`` of every leaf, the path ``/``-joined."""
    return [("/".join(path) if path else "leaf", leaf) for path, leaf in leaves_with_paths(tree)]


def _to_host(tree: Any) -> Any:
    """Every leaf as a host tensor of its own (a copy, so a later in-place
    train step does not change what is being written)."""
    return unflatten(tree, [t.detach().to("cpu", copy=True) if isinstance(t, torch.Tensor)
                            else t for _, t in _named_leaves(tree)])


def _as_numpy(t: Any) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(t)


@dataclasses.dataclass
class CheckpointManager:
    directory: str
    keep: int = 3
    async_save: bool = False

    def __post_init__(self):
        os.makedirs(self.directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}")

    def steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.directory):
            m = re.fullmatch(r"step_(\d+)", name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    # ------------------------------------------------------------------
    def save(self, state: Any, step: int, shardings: Any = None) -> None:
        """Commit ``state`` as ``step``. A synchronous save copies one
        leaf at a time to the host as it writes it; an asynchronous one
        copies the whole state first, so the train step may go on
        updating it in place. With ``shardings`` every rank of the mesh
        calls it: each leaf is gathered, the mesh's rank 0 writes, and
        every rank returns once the step is committed."""
        shs = [] if shardings is None else _sharding_leaves(shardings, state)
        mesh = next((sh.mesh for sh in shs if sh is not None), None)
        if mesh is not None:
            # leaf by leaf: no rank holds more than one whole leaf at a time
            self.wait()
            self._save_sync(state, step, shs, mesh)
            _barrier()
        elif self.async_save:
            self.wait()
            self._thread = threading.Thread(target=self._save_sync,
                                            args=(_to_host(state), step))
            self._thread.start()
        else:
            self._save_sync(state, step)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _save_sync(self, state: Any, step: int, shardings: Optional[List[Any]] = None,
                   mesh=None) -> None:
        """Write ``state`` as ``step``; on a mesh (``shardings`` the leaves'
        NamedShardings) every rank gathers each leaf and rank 0 writes."""
        writer = mesh is None or mesh.rank == 0
        final = self._step_dir(step)
        tmp = final + ".tmp"
        if writer:
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
        manifest: Dict[str, Any] = {"step": step, "leaves": []}
        named = _named_leaves(state)
        for (path, leaf), sh in zip(named, shardings or [None] * len(named)):
            if sh is not None:
                leaf = sh.unshard(leaf)
            if not writer:
                continue
            fname = path.replace("/", "__") + ".npy"
            arr = _as_numpy(leaf)
            bf16 = isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16
            np.save(os.path.join(tmp, fname), arr)
            manifest["leaves"].append(
                {"path": path, "file": fname, "dtype": "bfloat16" if bf16 else str(arr.dtype),
                 "shape": list(arr.shape)}
            )
        if not writer:
            return
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic commit
        self._gc()

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # ------------------------------------------------------------------
    def restore(self, step: int, template: Any, shardings: Any = None) -> Any:
        """The state of ``step`` shaped as ``template``: each leaf on its
        template leaf's device, bf16 leaves from their bits. With
        ``shardings`` (a tree of ``NamedSharding`` or None beside
        ``template``'s leaves) a leaf is this rank's shard of the stored
        one, and ``template`` holds shards."""
        d = self._step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        by_path = {e["path"]: e for e in manifest["leaves"]}
        named = _named_leaves(template)
        shs = _sharding_leaves(shardings, template) if shardings is not None else [None] * len(named)
        out = []
        for (path, tleaf), sh in zip(named, shs):
            entry = by_path[path]
            arr = np.load(os.path.join(d, entry["file"]), mmap_mode="r")
            want = tuple(tleaf.shape)
            if sh is not None:
                if sh.shard_shape(arr.shape) != want:
                    raise ValueError(
                        f"checkpoint leaf {path} shape {tuple(arr.shape)} does not shard into "
                        f"template {want} under {sh.spec}")
                arr = arr[sh.shard_slices(arr.shape)]
            elif tuple(arr.shape) != want:
                raise ValueError(
                    f"checkpoint leaf {path} shape {tuple(arr.shape)} != template {want}"
                )
            arr = np.array(arr)
            if entry["dtype"] == "bfloat16":
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(arr)
            out.append(t.to(tleaf.device) if isinstance(tleaf, torch.Tensor) else t)
        return unflatten(template, out)

    def restore_latest(self, template: Any, shardings: Any = None) -> Optional[Any]:
        step = self.latest_step()
        if step is None:
            return None
        return self.restore(step, template, shardings)


# ---------------------------------------------------------------------------
# a state on a mesh
# ---------------------------------------------------------------------------


def _sharding_leaves(shardings: Any, like: Any) -> List[Any]:
    """``shardings``' leaves in ``like``'s leaf order: a NamedSharding, or
    None where the tree has None (a leaf every rank holds whole)."""
    from repro_torch.core.dtensor import NamedSharding

    def walk(sh, tree):
        if tree is None:
            return []
        if not isinstance(tree, (dict, list, tuple)):
            return [sh if isinstance(sh, NamedSharding) else None]
        kids = lambda t: ([t[k] for k in sorted(t)] if isinstance(t, dict)  # noqa: E731
                          else list(t))
        shk = kids(sh) if sh is not None else [None] * len(kids(tree))
        return [x for s, t in zip(shk, kids(tree)) for x in walk(s, t)]

    return walk(shardings, like)


def _barrier() -> None:
    import torch.distributed as dist

    dist.barrier()
