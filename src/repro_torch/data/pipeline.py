"""Deterministic synthetic LM data (``repro/data/pipeline.py``).

Step-addressable (``batch_at(step)``) so restarts resume mid-epoch with
no duplicated or skipped batches: the data-side half of fault tolerance.
The numpy stream is the JAX package's, so ``batch_at`` is bit-equal to
it; :meth:`SyntheticLMData.torch_batch_at` puts a batch on a device, and
:meth:`SyntheticLMData.sharded_batch_at` puts this rank's block of it on
a rank of a mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import numpy as np
import torch

_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class SyntheticLMData:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    frontend: str = ""           # vision_stub | audio_stub | ""
    num_patches: int = 0
    encoder_seq: int = 0
    d_model: int = 0
    dtype: str = "float32"

    def _tokens(self, step: int, start: int, count: int) -> np.ndarray:
        """Markov-ish deterministic stream: token = f(step, row, col)."""
        rng = np.random.default_rng(self.seed + step * 1_000_003)
        rows = rng.integers(
            0, self.vocab_size, size=(self.global_batch, self.seq_len + 1), dtype=np.int64
        )
        return rows[start : start + count].astype(np.int32)

    def batch_at(self, step: int, *, start: int = 0,
                 count: Optional[int] = None) -> Dict[str, np.ndarray]:
        """The batch of ``step`` as numpy arrays: ``tokens`` and
        ``labels`` ``[count, seq_len]`` int32, and a frontend stub's
        ``patches`` / ``frames`` as ones (f32 for a bf16 model: numpy has
        no bf16; :meth:`torch_batch_at` casts them)."""
        count = count if count is not None else self.global_batch
        toks = self._tokens(step, start, count)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if self.frontend == "vision_stub":
            batch["patches"] = np.ones((count, self.num_patches, 1024), np.float32)
        elif self.frontend == "audio_stub":
            batch["frames"] = np.ones((count, self.encoder_seq, self.d_model), np.float32)
        return batch

    def torch_batch_at(self, step: int,
                       device: Union[str, torch.device] = "cpu") -> Dict[str, torch.Tensor]:
        """The batch of ``step`` on ``device`` (the JAX package's
        ``jax_batch_at``); frontend inputs in the model's dtype."""
        out = {}
        for k, v in self.batch_at(step).items():
            t = torch.from_numpy(np.ascontiguousarray(v)).to(device)
            out[k] = t if k in ("tokens", "labels") else t.to(_TORCH[self.dtype])
        return out

    def sharded_batch_at(self, step: int, mesh, pspec) -> Dict[str, torch.Tensor]:
        """This rank's block, under ``pspec`` (one entry per leading dim)
        on ``mesh`` (a ``launch.mesh.Mesh``), of every tensor of the batch
        of ``step``, on the mesh's device: what the reference's
        ``device_put`` with ``NamedSharding(mesh, pspec)`` leaves on the
        device at this rank's mesh coordinates."""
        from repro_torch.core.dtensor import NamedSharding

        sharding = NamedSharding(mesh, tuple(pspec))
        out = {}
        for k, v in self.batch_at(step).items():
            local = sharding.shard(torch.from_numpy(np.ascontiguousarray(v)))
            local = local.to(mesh.device)
            out[k] = local if k in ("tokens", "labels") else local.to(_TORCH[self.dtype])
        return out
