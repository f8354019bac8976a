"""Fault-tolerance drills: node failure -> checkpoint restore onto a new
device or a new process group's rank (elastic rescale), plus the
straggler policy knobs shared with the ADMM protocol layer.

Port of ``repro.train.fault``.  ``elastic_restore`` lays the restored
state out on a device mesh of any size whose axes divide the specced
dims (``shardings_for``), as the reference re-shards it under a smaller
mesh; without a mesh, every rank of a data-parallel group holds the
whole state, and a survivor restores it onto its own device.
"""
from __future__ import annotations

import dataclasses

from . import checkpoint as ckpt_mod
from ..launch.mesh import dp_rank, rank_device
from ..models import registry


@dataclasses.dataclass(frozen=True)
class StragglerPolicy:
    """Deadline-based partial aggregation (used by core/protocol.py)."""
    deadline_s: float = 1.0
    max_stale_rounds: int = 3


def shardings_for(mesh, pspecs):
    """``(mesh, placements)`` for each spec of a spec tree (``None``
    leaves stay None: restored whole on every rank)."""
    return registry.map_tree(
        lambda _, s: None if s is None else (mesh, registry.placements(s,
                                                                       mesh)),
        pspecs)


def elastic_restore(ckpt_dir: str, like, mesh=None, pspecs=None, step=None,
                    *, device=None, group=None):
    """Restore a checkpoint onto ``mesh`` (any size whose axes divide the
    dims ``pspecs`` shard; ``pspecs`` a spec tree like ``like``, e.g.
    ``loop.state_pspecs``), or without a mesh onto ``device``, or, with
    a process ``group``, onto this rank's device of type ``device`` (its
    own card, or the CPU).  ``like`` gives the structure (``meta``
    tensors will do).  Returns (state, manifest)."""
    if mesh is not None:
        return ckpt_mod.restore(ckpt_dir, like, step=step, device=device,
                                shardings=shardings_for(mesh, pspecs))
    if group is not None:
        device = rank_device(device, dp_rank(group))
    return ckpt_mod.restore(ckpt_dir, like, step=step, device=device)


def drill_fail_and_rescale(train_step, state, batches, ckpt_dir,
                           fail_after: int = 2, device=None):
    """Simulated failure drill used by tests:

    1. run ``fail_after`` steps, checkpointing each;
    2. lose the state and rebuild it on ``device`` (default: where it
       was) from the last checkpoint (elastic restore);
    3. continue training; return the loss trace across the failure.
    """
    losses = []
    for i, batch in enumerate(batches):
        if i == fail_after:
            state, _ = elastic_restore(ckpt_dir, state, device=device)
        state, metrics = train_step(state, batch)
        losses.append(float(metrics["loss"]))
        ckpt_mod.save(ckpt_dir, int(state["step"]), state)
    return state, losses
