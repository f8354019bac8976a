"""Host-side checkpointing with atomic writes and elastic restore.

Port of ``repro.train.checkpoint``, with its on-disk layout:
``<dir>/step_<N>/arrays.npz`` + ``manifest.json`` (``step``,
``n_arrays``, ``dtypes``, ``extra``), written to a temporary directory
and renamed into place.  Every leaf is saved under its key path, joined
with ``/``: dict keys, list indices, and for a
:class:`~repro_torch.models.layers.Params` tree its sub-trees, with a
``ModuleList`` index as a path element as a list index is in the
reference.  bfloat16 leaves are stored viewed as ``uint16``.  A
``DTensor`` leaf (a train state on a device mesh) is saved whole
(``full_tensor()``, a collective every rank of the mesh joins; global
rank 0 writes), so the format is the same and a checkpoint taken on one
mesh restores onto another.  ``restore(..., device=)`` puts each leaf on
the device asked for; ``restore(..., shardings=)`` lays leaves out on a
mesh, as the reference's ``shardings=`` does.

The port keeps a model's layers as a list where the reference stacks
them along axis 0, so the two packages' parameter keys differ; a
reference checkpoint enters the port through :func:`load_tree` and
``repro_torch.convert.train_state_from_numpy``.

The data-pipeline cursor is stored in the manifest so a restart resumes
the exact batch stream (no skipped or duplicated batches).
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from ..models.layers import Params


def _items(node):
    if isinstance(node, Params):
        node = node.tree()
    if isinstance(node, dict):
        return list(node.items())
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def _walk(node, prefix=""):
    """(key, leaf) pairs of a tree, keys joined with ``/``."""
    items = _items(node)
    if items is None:
        return [(prefix[:-1], node)]
    out = []
    for k, v in items:
        out.extend(_walk(v, f"{prefix}{k}/"))
    return out


def _to_numpy(leaf):
    """A leaf as a host numpy array, copied (so a later in-place update
    of a CPU tensor cannot reach it); bfloat16 as its uint16 bits.  A
    ``DTensor`` is gathered whole first."""
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), None
    return np.array(leaf), None


def _flatten(tree):
    """(arrays, dtypes, writer): ``writer`` is False on every rank but
    global rank 0 when the tree holds ``DTensor`` leaves (each rank
    gathers them, one writes)."""
    out, dtypes, sharded = {}, {}, False
    for key, leaf in _walk(tree):
        sharded |= isinstance(leaf, DTensor)
        arr, dt = _to_numpy(leaf)
        if dt:
            dtypes[key] = dt
        out[key] = arr
    return out, dtypes, not sharded or dist.get_rank() == 0


def _write(ckpt_dir, step, arrays, dtypes, extra) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    try:
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        manifest = {"step": step, "n_arrays": len(arrays),
                    "dtypes": dtypes, "extra": extra or {}}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)            # atomic publish
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


def save(ckpt_dir: str, step: int, tree, extra: dict | None = None) -> str:
    """Atomic checkpoint write; returns the final directory path.  A tree
    on a device mesh is saved by every rank's call (only global rank 0
    writes)."""
    arrays, dtypes, writer = _flatten(tree)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    return _write(ckpt_dir, step, arrays, dtypes, extra) if writer else final


def save_async(ckpt_dir: str, step: int, tree, extra: dict | None = None
               ) -> threading.Thread:
    """Overlap checkpoint I/O with the next train step (the leaves are
    copied to the host synchronously; the write happens on a worker
    thread, on global rank 0 for a tree on a device mesh)."""
    arrays, dtypes, writer = _flatten(tree)
    if not writer:
        t = threading.Thread(target=lambda: None, daemon=True)
        t.start()
        return t
    t = threading.Thread(target=_write,
                         args=(ckpt_dir, step, arrays, dtypes, extra),
                         daemon=True)
    t.start()
    return t


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_")]
    return max(steps) if steps else None


def _open(ckpt_dir, step):
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    return np.load(os.path.join(d, "arrays.npz")), manifest


def _tensor(arr, dtype_name):
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr if arr.flags.writeable else arr.copy())


def restore(ckpt_dir: str, like, step: int | None = None,
            device=None, shardings=None) -> tuple:
    """Restore into the structure of ``like``; returns (tree, manifest).

    ``like``'s leaves give the keys and the (global) shapes (``meta``
    tensors will do); each restored leaf goes to ``device``, or to the
    device of ``like``'s leaf (the CPU for a ``meta`` one).
    ``shardings``: an optional tree like ``like`` whose leaves are
    ``(mesh, placements)`` pairs (``fault.shardings_for``) or None; a
    leaf with a pair is laid out on that mesh as a ``DTensor`` (on the
    mesh's device), which restores onto a mesh of another size than the
    one that saved.  A ``Params`` comes back as a new ``Params``,
    trainable when ``like``'s was.
    """
    data, manifest = _open(ckpt_dir, step)
    dtypes = manifest.get("dtypes", {})

    def leaf(key, like_leaf, sharding):
        arr = data[key]
        shape = tuple(like_leaf.shape) if hasattr(like_leaf, "shape") \
            else np.shape(like_leaf)
        if tuple(arr.shape) != tuple(shape):
            raise ValueError(f"shape mismatch for {key}: "
                             f"{arr.shape} vs {shape}")
        t = _tensor(arr, dtypes.get(key))
        if sharding is not None:
            mesh, placements = sharding
            return distribute_tensor(t.to(device or mesh.device_type), mesh,
                                     placements)
        dev = device
        if dev is None:
            dev = getattr(like_leaf, "device", torch.device("cpu"))
            if dev.type == "meta":
                dev = torch.device("cpu")
        return t.to(dev)

    def sub(sh, k):
        return None if sh is None else sh[k]

    def build(node, prefix, sh):
        if isinstance(node, Params):
            out = Params(build(node.tree(), prefix, sh))
            if any(p.requires_grad for p in node.parameters()):
                out.requires_grad_(True)
            return out
        if isinstance(node, dict):
            return {k: build(v, f"{prefix}{k}/", sub(sh, k))
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v, f"{prefix}{i}/", sub(sh, i))
                              for i, v in enumerate(node))
        return leaf(prefix[:-1], node, sh)

    return build(like, "", shardings), manifest


def load_tree(ckpt_dir: str, step: int | None = None) -> tuple:
    """Every array of a checkpoint as a nested dict of CPU tensors (keys
    split at ``/``; integer keys stay strings), and the manifest; for a
    checkpoint whose structure the caller does not hold, such as one
    the reference wrote."""
    data, manifest = _open(ckpt_dir, step)
    dtypes = manifest.get("dtypes", {})
    root: dict = {}
    for key in data.files:
        node = root
        parts = key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = _tensor(data[key], dtypes.get(key))
    return root, manifest
