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
(enc-dec).  The reference's ``param_pspecs``, ``input_specs``,
``cache_specs`` and ``input_shardings`` serve its TPU dry-run's mesh and
are not ported with this slice.
"""
from __future__ import annotations

import types

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
