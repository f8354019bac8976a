"""Carry key material, limb state and model weights over from the
reference package.

``key_from_reference`` rebuilds a Paillier key from the reference key's
fields as Python ints (``dataclasses.asdict`` of a
``repro.core.paillier.PaillierKey``); ``limbs_from_numpy`` turns
reference limb arrays (numpy int32 ``(B, L16)``, as ``bigint.from_ints``,
``ModulusPack`` and ``CipherTensor.limbs`` hold them) into port tensors;
``lm_params_from_numpy`` builds a language model of ``repro_torch.models``
from the reference's parameter pytree as numpy arrays, and
``train_state_from_numpy`` a train state from the reference's (as
``repro.train.checkpoint.save`` writes it; read it back with
``repro_torch.train.checkpoint.load_tree``).  None imports the
reference: callers hand over plain data.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import resolve_device
from .core.paillier import PaillierKey
from .models import layers as L
from .models import registry


def key_from_reference(fields: dict) -> PaillierKey:
    """The port's key for the reference key's fields (Python ints)."""
    names = [f.name for f in dataclasses.fields(PaillierKey)]
    missing = [n for n in names if n not in fields]
    if missing:
        raise KeyError(f"reference key lacks fields {missing}")
    return PaillierKey(**{n: int(fields[n]) for n in names})


def limbs_from_numpy(arr, device=None) -> torch.Tensor:
    """Reference radix-2^16 limbs (int32, values < 2^16) as an int32
    tensor on ``device`` (default cuda)."""
    a = np.asarray(arr)
    if a.size and (a.min() < 0 or a.max() > 0xFFFF):
        raise ValueError("limb values must lie in [0, 2^16)")
    return torch.as_tensor(a.astype(np.int32), device=resolve_device(device))


def _flatten(tree, prefix=""):
    """Dotted leaf names of a nested dict/list tree (list items by index)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: tree}
    out = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}{k}."))
    return out


def _unstack(tree: dict) -> dict:
    """The reference's stacked layer subtrees as lists of per-layer trees."""
    out = dict(tree)
    for name in L.STACKED:
        if name in out and isinstance(out[name], dict):
            leaves = _flatten(out[name])
            n = {np.shape(a)[0] if np.ndim(a) else None
                 for a in leaves.values()}
            if len(n) != 1 or None in n:
                raise ValueError(f"{name!r}: leaves disagree on the layer "
                                 f"axis ({sorted(map(str, n))})")

            def take(t, i):
                return ({k: take(v, i) for k, v in t.items()}
                        if isinstance(t, dict) else np.asarray(t)[i])
            out[name] = [take(out[name], i) for i in range(n.pop())]
    return out


def _nest(flat: dict) -> dict:
    """Dotted names back to the nested dict/list tree."""
    root: dict = {}
    for name, v in flat.items():
        node = root
        parts = name.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = v

    def lists(t):
        if not isinstance(t, dict):
            return t
        if t and all(k.isdigit() for k in t):
            return [lists(t[str(i)]) for i in range(len(t))]
        return {k: lists(v) for k, v in t.items()}
    return lists(root)


def lm_params_from_numpy(cfg, tree: dict, device=None) -> L.Params:
    """The port's model for ``cfg`` holding the reference's weights.

    ``tree`` is the reference's parameter pytree with numpy leaves
    (``jax.tree.map(np.asarray, params)``).  The leading layer axis of
    ``layers`` (transformer) and ``enc``/``dec`` (enc-dec) is unstacked;
    ``blocks`` lists (xLSTM, Griffin) are taken as they are.  Raises
    ``KeyError`` on a missing or unexpected leaf and ``ValueError`` on a
    misshapen one.
    """
    dev = resolve_device(device)
    want = _flatten(registry.family_module(cfg).param_tree(cfg,
                                                           L.ShapeInit()))
    got = _flatten(_unstack(tree))
    missing = sorted(set(want) - set(got))
    extra = sorted(set(got) - set(want))
    if missing or extra:
        raise KeyError(f"{cfg.name}: missing leaves {missing}, unexpected "
                       f"leaves {extra}")
    flat = {}
    for name, skel in want.items():
        a = np.asarray(got[name])
        if a.shape != tuple(skel.shape):
            raise ValueError(f"{cfg.name}: leaf {name} has shape {a.shape}, "
                             f"expected {tuple(skel.shape)}")
        flat[name] = torch.as_tensor(a.astype(np.float32), device=dev)
    return L.Params(_nest(flat))


def train_state_from_numpy(cfg, tree: dict, device=None) -> dict:
    """The port's train state holding a reference train state.

    ``tree`` is ``{"params", "opt": {"m", "v", "count"}, "step"}`` with
    numpy (or CPU tensor) leaves, the stacked ``layers``/``enc``/``dec``
    subtrees as the reference keeps them.  Parameters come back
    trainable, ``m`` and ``v`` as trees of the same structure, ``count``
    and ``step`` as int32 scalars; the next train step of either package
    then starts from the same numbers.
    """
    dev = resolve_device(device)
    params = lm_params_from_numpy(cfg, tree["params"], dev)
    params.requires_grad_(True)

    def scalar(a):
        return torch.as_tensor(np.asarray(a).astype(np.int32), device=dev)
    return {"params": params,
            "opt": {"m": lm_params_from_numpy(cfg, tree["opt"]["m"], dev),
                    "v": lm_params_from_numpy(cfg, tree["opt"]["v"], dev),
                    "count": scalar(tree["opt"]["count"])},
            "step": scalar(tree["step"])}
