"""Model registry: one API across the five families.

Port of ``repro.models.registry``'s single-card half.  ``get_model(cfg)``
returns a namespace of plain functions:

* ``init(cfg, seed=0, device=None)`` -> :class:`~.layers.Params`, float32
  parameters drawn from a seeded ``torch.Generator`` on ``device``
  (default ``cuda``);
* ``forward(params, tokens, cfg, **inputs)`` -> float32 logits (B, S, V)
  (``remat=True`` recomputes each block in the backward pass; the
  reference's ``use_scan`` is accepted where it has one);
* ``loss_fn(params, batch, cfg, **kw)`` -> mean next-token NLL, which a
  trainer differentiates (``Params.requires_grad_()``);
* ``init_cache(cfg, batch, max_len, device=None)``;
* ``prefill(params, tokens, cfg, cache, **inputs)`` -> (last logits, cache);
* ``decode_step(params, token, cache, cfg)`` -> (logits (B, V), cache).

Extra inputs: ``prefix_embeds`` (VLM stub, dense family) and ``frames``
(enc-dec).

Sharding: ``param_pspecs`` derives the 2-D (FSDP on ``data`` x TP on
``model``) spec tree of a parameter tree from its leaf names, with the
reference's rules; ``input_specs``/``cache_specs`` build the ``meta``
tensor stand-ins of every (arch x shape) dry-run cell (the reference's
``ShapeDtypeStruct``s: no storage) and ``input_shardings`` their specs.
A spec is a :class:`P`, one entry per tensor dim; :func:`placements`
turns it into DTensor placements on a ``DeviceMesh`` and
:func:`distribute_params` lays a ``Params`` tree out on one.
"""
from __future__ import annotations

import os
import types

import torch

from . import encdec, griffin, transformer, xlstm
from . import layers as L
from .config import ModelConfig

# Shapes assigned to the LM pool (seq_len x global_batch)
SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}

FAMILIES = {"dense": transformer, "moe": transformer, "encdec": encdec,
            "xlstm": xlstm, "griffin": griffin}


def family_module(cfg: ModelConfig):
    try:
        return FAMILIES[cfg.family]
    except KeyError:
        raise ValueError(f"unknown family {cfg.family}") from None


def get_model(cfg: ModelConfig) -> types.SimpleNamespace:
    m = family_module(cfg)
    return types.SimpleNamespace(
        init=m.init_params, forward=m.forward,
        loss_fn=getattr(m, "loss_fn", None) or _generic_loss(m),
        prefill=m.prefill, decode_step=m.decode_step,
        init_cache=m.init_cache,
    )


def _generic_loss(m):
    def loss_fn(params, batch, cfg, **kw):
        return L.nll(m.forward(params, batch["tokens"], cfg, **kw),
                     batch["labels"])
    return loss_fn


def enc_len(cfg, seq: int) -> int:
    return max(64, min(1024, seq // 4))


# ---------------------------------------------------------------------------
# Parameter sharding: name-based rules, FSDP on `data`, TP on `model`
# ---------------------------------------------------------------------------

class P(tuple):
    """A partition spec: per tensor dim ``None`` (replicated), a mesh axis
    name, or a tuple of names (sharded over their product, the first
    major), as the reference's ``PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


_RULES: dict[str, tuple] = {
    # embeddings / head
    "embed": ("model", None),
    "head": ("data", "model"),
    # attention / generic in->out projections
    "wq": ("data", "model"), "wk": ("data", "model"), "wv": ("data", "model"),
    "w_gate": ("data", "model"), "w_up": ("data", "model"),
    "w_q": ("data", "model"), "w_k": ("data", "model"),
    "w_v": ("data", "model"), "w_o": ("data", "model"),
    "w_x": ("data", "model"), "w_rg": ("data", "model"),
    "w_ig": ("data", "model"),
    # out->residual projections
    "wo": ("model", "data"), "w_down": ("model", "data"),
    "w_y": ("model", "data"),
    # MoE expert-stacked weights (E on model = expert parallelism)
    "we_gate": ("model", "data", None), "we_up": ("model", "data", None),
    "we_down": ("model", None, "data"),
    "router": (None, None),
    # biases / small vectors
    "bq": ("model",), "bk": ("model",), "bv": ("model",),
    "lam": ("model",),
    "conv": (None, "model"),
    # xlstm specials
    "w_i": ("data", None), "w_f": ("data", None),
    "b_i": (None,), "b_f": (None,),
    "r_z": (None, None, None),
}


def _leaf_name(path) -> str:
    """The last dict key of a leaf's path (list indices skipped)."""
    for p in reversed(path):
        if isinstance(p, str):
            return p
    return ""


def _divides(n: int | None, axis, mesh_shape: dict) -> bool:
    if axis is None:
        return True
    if axis not in mesh_shape:      # axis absent from this mesh: replicate
        return False
    return n is not None and n % mesh_shape[axis] == 0


def map_tree(fn, tree, path=()):
    """``fn(path, leaf)`` over a nested dict/list tree (a ``Params`` is
    read as its ``tree()``); path elements are dict keys (str) and list
    indices (int); a spec :class:`P` is a leaf."""
    if isinstance(tree, L.Params):
        tree = tree.tree()
    if isinstance(tree, P):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_tree(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def tree_leaves(tree) -> list:
    """A tree's leaves in ``Params`` registration order (dict order,
    list order)."""
    out = []
    map_tree(lambda _, leaf: out.append(leaf), tree)
    return out


def param_pspecs(cfg: ModelConfig, params, mesh_shape: dict | None = None):
    """Spec tree mirroring ``params`` (a ``Params``, or its ``tree()`` of
    tensors or ``meta`` stand-ins).

    ``mesh_shape``: {'data': 16, 'model': 16}; any rule whose axis does not
    divide the dim falls back to replication for that dim.  A leaf of a
    per-layer list (:data:`~.layers.STACKED`) is specced as the reference
    specs its layer-stacked array, whose leading layer dim is never
    sharded, and that dim's ``None`` dropped: the reference's spec with
    the stacked axis removed.
    """
    mesh_shape = mesh_shape or {"data": 16, "model": 16}

    def one(path, leaf):
        rule = _RULES.get(_leaf_name(path))
        if rule is None:
            return P()
        stacked = len(path) > 1 and path[0] in L.STACKED \
            and isinstance(path[1], int)
        shape = ((None,) if stacked else ()) + tuple(leaf.shape)
        nd = len(shape)
        rule = list(rule)
        if nd == len(rule) + 1:      # layer-stacked leading dim
            rule = [None] + rule
        elif nd != len(rule):
            return P()
        out = [axis if _divides(dim, axis, mesh_shape) else None
               for dim, axis in zip(shape, rule)]
        if stacked:
            if out[0] is not None:
                raise ValueError(f"{'/'.join(map(str, path))}: a rule "
                                 f"shards the layer axis ({out[0]!r})")
            out = out[1:]
        # drop trailing Nones for tidiness
        while out and out[-1] is None:
            out.pop()
        return P(*out)

    return map_tree(one, params)


# ---------------------------------------------------------------------------
# Specs on a DeviceMesh
# ---------------------------------------------------------------------------

def placements(spec, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``.

    A spec is indexed by tensor dim, placements by mesh dim: tensor dim d
    sharded over mesh axis a puts ``Shard(d)`` at a's mesh dim, and every
    mesh dim no entry names is ``Replicate()``.  A tuple entry shards its
    dim over each of its axes, which must come in mesh order (DTensor
    splits over mesh dims left to right, the first major, as a
    ``PartitionSpec`` tuple does)."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes if a is not None]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} is not in the mesh's "
                             f"axis order {names}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"mesh axis {names[i]!r} shards two dims "
                                 f"of {spec!r}")
            out[i] = Shard(d)
    return out


def distribute_params(params: L.Params, mesh, specs) -> L.Params:
    """A new ``Params`` whose leaves are ``DTensor``s on ``mesh`` at the
    placements of ``specs`` (a tree like ``param_pspecs`` gives),
    trainable when ``params`` was; the counterpart of the reference's
    ``device_put(x, NamedSharding(mesh, spec))`` over a tree."""
    from torch.distributed.tensor import distribute_tensor
    trainable = any(p.requires_grad for p in params.parameters())
    flat = iter(tree_leaves(specs))
    tree = map_tree(lambda _, leaf: distribute_tensor(
        leaf.detach(), mesh, placements(next(flat), mesh)), params)
    out = L.Params(tree)
    if trainable:
        out.requires_grad_(True)
    return out


# ---------------------------------------------------------------------------
# Input specs (meta tensors) + shardings per (shape, kind)
# ---------------------------------------------------------------------------

def _sd(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape_name: str) -> dict:
    """``meta`` tensor stand-ins for one dry-run cell, in the reference's
    dtypes (token ids int32).

    train  -> {"batch": {tokens, labels[, prefix_embeds | frames]}}
    prefill-> {"tokens": ..., "cache": ...[, extras]}
    decode -> {"token": ..., "cache": ...}

    ``shape_name`` may also be a shape of one's own, a dict like those of
    :data:`SHAPES`.
    """
    sh = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    B, S = sh["batch"], sh["seq"]
    extras = {}
    if cfg.frontend == "vision":
        extras["prefix_embeds"] = _sd((B, cfg.n_prefix, cfg.d_model),
                                      torch.bfloat16)
    if cfg.family == "encdec":
        extras["frames"] = _sd((B, enc_len(cfg, S), cfg.d_model),
                               torch.bfloat16)
    if sh["kind"] == "train":
        return {"batch": {"tokens": _sd((B, S), torch.int32),
                          "labels": _sd((B, S), torch.int32), **extras}}
    if sh["kind"] == "prefill":
        return {"tokens": _sd((B, S), torch.int32),
                "cache": cache_specs(cfg, B, S), **extras}
    cache = cache_specs(cfg, B, S, with_cross=cfg.family == "encdec")
    return {"token": _sd((B,), torch.int32), "cache": cache}


def cache_specs(cfg: ModelConfig, B: int, S: int, with_cross: bool = False,
                quantized: bool | None = None):
    """``meta`` tree matching the reference's ``init_cache`` output
    (``len`` an int32 scalar).

    ``quantized`` (or env REPRO_KV_QUANT=1): int8 KV cache with per-head
    scales."""
    if quantized is None:
        quantized = os.environ.get("REPRO_KV_QUANT") == "1"
    i32, f32, bf16 = torch.int32, torch.float32, torch.bfloat16
    if cfg.family in ("dense", "moe"):
        # VLM: the prefix embeddings occupy cache slots too
        S_tot = S + (cfg.n_prefix if cfg.frontend == "vision" else 0)
        shape = (cfg.n_layers, B, S_tot, cfg.n_kv, cfg.hd)
        if quantized:
            sshape = (cfg.n_layers, B, S_tot, cfg.n_kv)
            return {"k": _sd(shape, torch.int8), "v": _sd(shape, torch.int8),
                    "k_scale": _sd(sshape, f32), "v_scale": _sd(sshape, f32),
                    "len": _sd((), i32)}
        return {"k": _sd(shape, bf16), "v": _sd(shape, bf16),
                "len": _sd((), i32)}
    if cfg.family == "encdec":
        shape = (cfg.dec_layers, B, S, cfg.n_kv, cfg.hd)
        out = {"k": _sd(shape, bf16), "v": _sd(shape, bf16),
               "len": _sd((), i32)}
        if with_cross:
            cs = (cfg.dec_layers, B, enc_len(cfg, S), cfg.n_kv, cfg.hd)
            out["cross"] = {"ck": _sd(cs, bf16), "cv": _sd(cs, bf16)}
        return out
    if cfg.family == "xlstm":
        H = cfg.n_heads
        hd = int(cfg.proj_factor * cfg.d_model) // H
        states = []
        for i in range(cfg.n_layers):
            if xlstm.is_slstm(cfg, i):
                states.append({"c": _sd((B, H, hd), f32),
                               "n": _sd((B, H, hd), f32),
                               "m": _sd((B, H), f32),
                               "h": _sd((B, H, hd), f32)})
            else:
                states.append({"C": _sd((B, H, hd, hd), f32),
                               "n": _sd((B, H, hd), f32),
                               "m": _sd((B, H), f32)})
        return {"states": states, "len": _sd((), i32)}
    if cfg.family == "griffin":
        w = griffin.lru_width(cfg)
        win = cfg.window or 2048
        states = []
        for i in range(cfg.n_layers):
            if griffin.layer_kind(cfg, i) == "attn":
                states.append({"k": _sd((B, win, cfg.n_kv, cfg.hd), bf16),
                               "v": _sd((B, win, cfg.n_kv, cfg.hd), bf16),
                               "pos": _sd((win,), i32)})
            else:
                states.append({"conv": _sd((B, cfg.conv_width - 1, w), bf16),
                               "h": _sd((B, w), f32)})
        return {"states": states, "len": _sd((), i32)}
    raise ValueError(cfg.family)


def input_shardings(cfg: ModelConfig, shape_name: str, specs,
                    dp_axes=("data",), mesh_shape: dict | None = None):
    """Spec tree matching :func:`input_specs` output.

    Batch dims shard over ``dp_axes`` (('pod','data') multi-pod); decode KV
    caches additionally shard their sequence dim over 'model' (sequence-
    parallel KV).
    """
    mesh_shape = mesh_shape or {"data": 16, "model": 16}
    dp = 1
    for a in dp_axes:
        dp *= mesh_shape.get(a, 1)
    dp_spec = tuple(dp_axes) if len(dp_axes) > 1 else dp_axes[0]

    def shard_batch(path, leaf):
        shape = leaf.shape
        name = _leaf_name(path)
        nd = len(shape)
        if nd == 0:
            return P()
        # KV caches: (L, B, S, KV, hd) — batch on dp, seq on model
        if name in ("k", "v", "ck", "cv") and nd == 5:
            b_ok = shape[1] % dp == 0
            s_ok = shape[2] % mesh_shape.get("model", 1) == 0
            return P(None, dp_spec if b_ok else None,
                     "model" if s_ok else None, None, None)
        if name in ("k", "v") and nd == 4:   # griffin ring (B, win, KV, hd)
            return P(dp_spec if shape[0] % dp == 0 else None)
        if name == "pos":
            return P()
        # generic: shard dim 0 if it is the batch and divisible
        if name in ("tokens", "labels", "token", "prefix_embeds", "frames",
                    "C", "n", "m", "c", "h", "conv"):
            return P(dp_spec if shape[0] % dp == 0 else None)
        return P()

    return map_tree(shard_batch, specs)
