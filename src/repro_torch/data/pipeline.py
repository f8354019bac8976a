"""Checkpointable data pipeline for the LM trainer.

Port of ``repro.data.pipeline``.  A deterministic function of (seed,
step): the cursor is the state, so resuming from a checkpoint replays no
batch and skips none.  ``next(device=...)`` puts a rank's rows of the
global batch on the device: for data parallelism over ``world`` ranks,
rank r takes rows ``[r B / world, (r + 1) B / world)``, the rows the
reference's ``NamedSharding`` over the ``data`` axis gives device r.
``next(mesh=...)`` returns the batch as ``DTensor``s on a device mesh,
each data coordinate holding its rows, replicated over the other axes
(the reference's ``pipe.next(mesh=, dp_axes=)``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import synthetic


@dataclasses.dataclass
class TokenPipeline:
    vocab: int
    batch: int
    seq: int
    seed: int = 0
    step: int = 0
    prefix: int = 0              # VLM prefix embeddings per example
    d_model: int = 0
    enc_len: int = 0             # enc-dec frame length

    def state(self) -> dict:
        return {"seed": self.seed, "step": self.step}

    def load_state(self, st: dict):
        self.seed = int(st["seed"])
        self.step = int(st["step"])

    def next(self, device=None, rank: int = 0, world: int = 1,
             mesh=None) -> dict:
        """The next global batch: numpy arrays when neither ``device`` nor
        ``mesh`` is given (the reference's batch, byte for byte), else
        this rank's rows as tensors on ``device`` (token ids as int64).
        With ``mesh``, rank and world are its coordinate and size over
        its data-parallel axes (``launch.mesh.dp_axes``), and each leaf
        is a ``DTensor`` sharded over them on ``device`` (default the
        mesh's device type)."""
        if mesh is not None:
            return self._next_on(mesh, device)
        b = synthetic.token_batch(self.vocab, self.batch, self.seq,
                                  self.step, self.seed)
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, self.step, 7]))
        if self.prefix and self.d_model:
            b["prefix_embeds"] = rng.normal(
                0, 0.02, (self.batch, self.prefix, self.d_model)
            ).astype(np.float32)
        if self.enc_len and self.d_model:
            b["frames"] = rng.normal(
                0, 0.02, (self.batch, self.enc_len, self.d_model)
            ).astype(np.float32)
        self.step += 1
        if device is None:
            return b
        return self._rows(b, device, rank, world)

    def _rows(self, b: dict, device, rank: int, world: int) -> dict:
        if world < 1 or not 0 <= rank < world or self.batch % world:
            raise ValueError(f"rank {rank} of {world}: the batch of "
                             f"{self.batch} does not split evenly")
        per = self.batch // world
        out = {}
        for k, v in b.items():
            t = torch.as_tensor(v[rank * per:(rank + 1) * per])
            if t.dtype == torch.int32:
                t = t.long()
            out[k] = t.to(device)
        return out

    def _next_on(self, mesh, device) -> dict:
        from torch.distributed.tensor import DTensor, Replicate, Shard

        from ..launch.mesh import dp_axes
        names = list(mesh.mesh_dim_names)
        dims = [names.index(a) for a in dp_axes(mesh)]
        coord = mesh.get_coordinate()
        rank, world = 0, 1
        for d in dims:                    # the first axis major
            rank = rank * mesh.shape[d] + coord[d]
            world *= mesh.shape[d]
        local = self._rows(self.next(), device or mesh.device_type, rank,
                           world)
        pl = [Shard(0) if d in dims else Replicate()
              for d in range(mesh.ndim)]
        return {k: DTensor.from_local(v, mesh, pl, run_check=False)
                for k, v in local.items()}
