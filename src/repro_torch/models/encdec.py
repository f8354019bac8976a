"""Encoder-decoder transformer (SeamlessM4T-medium text/speech backbone).

Port of ``repro.models.encdec``.  The modality frontend is a stub: the
encoder consumes precomputed frame embeddings (B, S_enc, d_model).  The
decoder is a causal LM with cross-attention; serving carries the
decoder's self-attention KV cache (bfloat16) and the cross-attention K/V
computed once from the encoder memory (``cache["cross"]``).  Caches are
state, as in :mod:`.transformer`.
"""
from __future__ import annotations

import torch

from .. import resolve_device
from . import layers as L
from .transformer import write_prompt


def init_enc_layer(init: L.Init, cfg) -> dict:
    return {
        "ln_attn": init.zeros((cfg.d_model,)),
        "ln_mlp": init.zeros((cfg.d_model,)),
        "attn": L.init_attn(init, cfg),
        "mlp": L.init_mlp(init, cfg.d_model, cfg.d_ff),
    }


def init_dec_layer(init: L.Init, cfg) -> dict:
    return {
        "ln_self": init.zeros((cfg.d_model,)),
        "ln_cross": init.zeros((cfg.d_model,)),
        "ln_mlp": init.zeros((cfg.d_model,)),
        "self_attn": L.init_attn(init, cfg),
        "cross_attn": L.init_attn(init, cfg),
        "mlp": L.init_mlp(init, cfg.d_model, cfg.d_ff),
    }


def param_tree(cfg, init: L.Init) -> dict:
    return {
        "embed": init.embed(cfg.padded_vocab, cfg.d_model),
        "enc": [init_enc_layer(init, cfg) for _ in range(cfg.enc_layers)],
        "dec": [init_dec_layer(init, cfg) for _ in range(cfg.dec_layers)],
        "ln_enc": init.zeros((cfg.d_model,)),
        "ln_f": init.zeros((cfg.d_model,)),
        "head": init.dense((cfg.d_model, cfg.padded_vocab)),
    }


def init_params(cfg, seed: int = 0, device=None) -> L.Params:
    return L.Params(param_tree(cfg, L.make_init(device, seed)))


def _enc_block(lp, x, cfg, positions):
    hn = L.rms_norm(x, lp["ln_attn"], cfg.norm_eps)
    q, k, v = L.qkv_proj(lp["attn"], hn, cfg, positions)
    o = L.attention(q, k, v, causal=False)
    x = x + L.attn_out(lp["attn"], o, cfg)
    hn = L.rms_norm(x, lp["ln_mlp"], cfg.norm_eps)
    return x + L.mlp(lp["mlp"], hn, cfg.act)


def encode(params, frames, cfg, use_scan=True, remat=False, **_):
    """frames: (B, S_enc, d) precomputed frontend embeddings.
    ``use_scan`` changes no number (the layers are a list)."""
    x = frames.to(L.cdtype(cfg))
    positions = torch.arange(x.shape[1], device=x.device)[None]
    for lp in params["enc"]:
        x = L.constrain_acts(L.remat_call(_enc_block, remat, lp, x, cfg,
                                          positions))
    return L.rms_norm(x, params["ln_enc"], cfg.norm_eps)


def _cross_kv(lp, memory, cfg):
    B, T, _ = memory.shape
    mk = memory @ lp["cross_attn"].w("wk", memory.dtype)
    mv = memory @ lp["cross_attn"].w("wv", memory.dtype)
    return (L.split_heads(mk, cfg.n_kv, cfg.hd),
            L.split_heads(mv, cfg.n_kv, cfg.hd))


def _dec_block(lp, h, ck, cv, cfg, positions, kv_out=None):
    """One decoder block against cross K/V ``ck``/``cv``."""
    hn = L.rms_norm(h, lp["ln_self"], cfg.norm_eps)
    q, k, v = L.qkv_proj(lp["self_attn"], hn, cfg, positions)
    if kv_out is not None:
        kv_out.append((k, v))
    o = L.attention(q, k, v, causal=True)
    h = h + L.attn_out(lp["self_attn"], o, cfg)
    hn = L.rms_norm(h, lp["ln_cross"], cfg.norm_eps)
    q, _, _ = L.qkv_proj(lp["cross_attn"], hn, cfg, positions)
    o = L.attention(q, ck, cv, causal=False)
    h = h + L.attn_out(lp["cross_attn"], o, cfg)
    hn = L.rms_norm(h, lp["ln_mlp"], cfg.norm_eps)
    return h + L.mlp(lp["mlp"], hn, cfg.act)


def _dec_layer(lp, x, memory, cfg, positions):
    ck, cv = _cross_kv(lp, memory, cfg)
    return _dec_block(lp, x, ck, cv, cfg, positions)


def forward(params, tokens, cfg, *, frames=None, use_scan=True, remat=False,
            **_):
    """Training forward: frames -> encoder; tokens -> decoder; logits."""
    memory = encode(params, frames, cfg, use_scan, remat)
    x = L.embed(params, tokens, cfg)
    positions = torch.arange(tokens.shape[1], device=x.device)[None]
    for lp in params["dec"]:
        x = L.constrain_acts(L.remat_call(_dec_layer, remat, lp, x, memory,
                                          cfg, positions))
    return L.head_logits(params, x, cfg)


def loss_fn(params, batch, cfg, **fwd_kwargs):
    logits = forward(params, batch["tokens"], cfg, frames=batch["frames"],
                     **fwd_kwargs)
    return L.nll(logits, batch["labels"])


# ---------------------------------------------------------------------------
# Serving: decoder self-attn KV cache + precomputed cross K/V
# ---------------------------------------------------------------------------

def init_cache(cfg, batch, max_len, dtype=torch.bfloat16, device=None):
    dev = resolve_device(device)
    shape = (cfg.dec_layers, batch, max_len, cfg.n_kv, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev), "len": 0}


def precompute_cross(params, memory, cfg):
    """Per-layer cross-attention K/V from the encoder memory, stacked
    (dec_layers, B, T, KV, hd)."""
    kvs = [_cross_kv(lp, memory, cfg) for lp in params["dec"]]
    return {"ck": torch.stack([k for k, _ in kvs]),
            "cv": torch.stack([v for _, v in kvs])}


def prefill(params, tokens, cfg, cache, *, frames=None, **_):
    memory = encode(params, frames, cfg)
    cross = precompute_cross(params, memory.to(L.cdtype(cfg)), cfg)
    x = L.embed(params, tokens, cfg)
    S = tokens.shape[1]
    positions = torch.arange(S, device=x.device)[None]
    kv = []
    for i, lp in enumerate(params["dec"]):
        x = _dec_block(lp, x, cross["ck"][i], cross["cv"][i], cfg,
                       positions, kv_out=kv)
    write_prompt(cache, torch.stack([k for k, _ in kv]),
                 torch.stack([v for _, v in kv]), S)
    cache["cross"] = cross
    return L.head_logits(params, x[:, -1:], cfg), cache


def decode_step(params, token, cache, cfg, **_):
    x = L.embed(params, token, cfg)[:, None, :]
    pos = cache["len"]
    slot = min(pos, cache["k"].shape[2] - 1)
    positions = torch.full((1, 1), pos, device=x.device)
    cross = cache["cross"]
    for i, lp in enumerate(params["dec"]):
        kc, vc = cache["k"][i], cache["v"][i]
        ck, cv = cross["ck"][i], cross["cv"][i]
        hn = L.rms_norm(x, lp["ln_self"], cfg.norm_eps)
        q, k, v = L.qkv_proj(lp["self_attn"], hn, cfg, positions)
        kc[:, slot] = k[:, 0].to(kc.dtype)
        vc[:, slot] = v[:, 0].to(vc.dtype)
        o = L.attention_decode(q, kc, vc, pos + 1)
        x = x + L.attn_out(lp["self_attn"], o, cfg)
        hn = L.rms_norm(x, lp["ln_cross"], cfg.norm_eps)
        q, _, _ = L.qkv_proj(lp["cross_attn"], hn, cfg, positions)
        o = L.attention_decode(q, ck, cv, ck.shape[1])
        x = x + L.attn_out(lp["cross_attn"], o, cfg)
        hn = L.rms_norm(x, lp["ln_mlp"], cfg.norm_eps)
        x = x + L.mlp(lp["mlp"], hn, cfg.act)
    cache["len"] = pos + 1
    return L.head_logits(params, x, cfg)[:, 0], cache
