"""Dense decoder-only transformer LM (also the VLM backbone).

Port of ``repro.models.transformer``: GQA + RoPE, optional QKV bias,
SwiGLU MLP or MoE blocks (the afmoe block too: per-layer window and
RoPE, q/k norms, an output gate, sandwich norms, scaled embeddings,
leading dense layers, sigmoid routing), KV-cache prefill/decode
(bfloat16 cache, or int8 with per-position scales), and an optional
prefix-embedding input for the VLM frontend stub.  Layers are an ``nn.ModuleList`` run one
after another, where the reference stacks them under ``vmap``/``scan``;
``forward``'s ``use_scan`` is accepted for that reason and changes no
number, and ``remat`` (on by default, as in the reference) recomputes
each block's activations in the backward pass.

Caches are state: ``prefill`` and ``decode_step`` write into the cache
they are given and return it.  ``cache["len"]`` is a Python int.  A
decode write lands at ``min(len, max_len - 1)``, as the reference's
``dynamic_update_slice`` clamps an out-of-range start to the last slot.
"""
from __future__ import annotations

import torch

from .. import resolve_device
from . import layers as L
from . import moe as moe_mod


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_layer(init: L.Init, cfg, i: int = 0) -> dict:
    p = {
        "ln_attn": init.zeros((cfg.d_model,)),
        "ln_mlp": init.zeros((cfg.d_model,)),
        "attn": L.init_attn(init, cfg),
    }
    if cfg.afmoe:
        p["ln_attn_post"] = init.zeros((cfg.d_model,))
        p["ln_mlp_post"] = init.zeros((cfg.d_model,))
    if cfg.layer_is_moe(i):
        p["moe"] = moe_mod.init_moe(init, cfg)
    else:
        p["mlp"] = L.init_mlp(init, cfg.d_model, cfg.d_ff)
    return p


def param_tree(cfg, init: L.Init) -> dict:
    tree = {
        "embed": init.embed(cfg.padded_vocab, cfg.d_model),
        "layers": [init_layer(init, cfg, i) for i in range(cfg.n_layers)],
        "ln_f": init.zeros((cfg.d_model,)),
    }
    if not cfg.tie_embeddings:
        tree["head"] = init.dense((cfg.d_model, cfg.padded_vocab))
    return tree


def init_params(cfg, seed: int = 0, device=None) -> L.Params:
    params = L.Params(param_tree(cfg, L.make_init(device, seed)))
    if cfg.router == "sigmoid":
        for lp in params["layers"]:
            if "moe" in lp:
                moe_mod.add_bias_state(lp["moe"], cfg)
    return params


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _ffn(lp, h, cfg):
    if "moe" in lp:
        return moe_mod.moe_block(lp["moe"], h, cfg)
    return L.mlp(lp["mlp"], h, cfg.act)


def _post(lp, name, y, cfg):
    """``y`` through the sandwich norm ``name`` in the afmoe block."""
    return L.rms_norm(y, lp[name], cfg.norm_eps) if cfg.afmoe else y


def block(lp, x, cfg, positions, kv_out=None, i=0):
    """Layer ``i`` (its attention window and RoPE, ``cfg.layer_window``
    and ``cfg.layer_rope``) on the residual stream ``x``."""
    h = L.rms_norm(x, lp["ln_attn"], cfg.norm_eps)
    q, k, v = L.qkv_proj(lp["attn"], h, cfg, positions, cfg.layer_rope(i))
    if kv_out is not None:
        kv_out.append((k, v))
    o = L.attention(q, k, v, causal=True, window=cfg.layer_window(i))
    x = x + _post(lp, "ln_attn_post", L.attn_out(lp["attn"], o, cfg, h), cfg)
    h = L.rms_norm(x, lp["ln_mlp"], cfg.norm_eps)
    return x + _post(lp, "ln_mlp_post", _ffn(lp, h, cfg), cfg)


def _inputs(params, tokens, cfg, prefix_embeds):
    x = L.embed(params, tokens, cfg)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    return x


def forward(params, tokens, cfg, *, prefix_embeds=None, use_scan=True,
            remat=True):
    """tokens (B, S) [+ optional prefix (B, P, d_model)] -> logits.

    With a prefix, logits are returned for the S token positions only.
    """
    x = _inputs(params, tokens, cfg, prefix_embeds)
    P = 0 if prefix_embeds is None else prefix_embeds.shape[1]
    positions = torch.arange(x.shape[1], device=x.device)[None]
    for i, lp in enumerate(params["layers"]):
        x = L.constrain_acts(L.remat_call(block, remat, lp, x, cfg,
                                          positions, None, i))
    return L.head_logits(params, x[:, P:], cfg)


def loss_fn(params, batch, cfg, **fwd_kwargs):
    logits = forward(params, batch["tokens"], cfg,
                     prefix_embeds=batch.get("prefix_embeds"), **fwd_kwargs)
    return L.nll(logits, batch["labels"])


# ---------------------------------------------------------------------------
# KV-cache inference
# ---------------------------------------------------------------------------

def init_cache(cfg, batch, max_len, dtype=torch.bfloat16, quantized=False,
               device=None) -> dict:
    """KV cache (bfloat16 whatever ``cfg.dtype``); ``quantized=True``
    stores int8 K/V with per-(layer, batch, position, kv-head) scales."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv, cfg.hd)
    if quantized:
        sshape = (cfg.n_layers, batch, max_len, cfg.n_kv)
        return {"k": torch.zeros(shape, dtype=torch.int8, device=dev),
                "v": torch.zeros(shape, dtype=torch.int8, device=dev),
                "k_scale": torch.full(sshape, 1e-6, device=dev),
                "v_scale": torch.full(sshape, 1e-6, device=dev),
                "len": 0}
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev), "len": 0}


def _kv_quantize(x):
    """x (B,S,KV,hd) -> (int8, per-(B,S,KV) max-abs scale)."""
    x32 = x.float()
    s = torch.clamp(x32.abs().amax(dim=3), min=1e-6)
    q = torch.clamp(torch.round(x32 / s[..., None] * 127.0), -127, 127)
    return q.to(torch.int8), s


def _kv_dequantize(q, scale, dtype):
    """q (B,S,KV,hd) int8, scale (B,S,KV) -> dtype."""
    return (q.float() * (scale[..., None] / 127.0)).to(dtype)


def write_prompt(cache, ks, vs, S):
    """Prefill's write of (L, B, S, KV, hd) keys and values at slot 0."""
    if S > cache["k"].shape[2]:
        raise ValueError(f"prompt of {S} positions exceeds the cache's "
                         f"{cache['k'].shape[2]}")
    cache["k"][:, :, :S] = ks.to(cache["k"].dtype)
    cache["v"][:, :, :S] = vs.to(cache["v"].dtype)
    cache["len"] = S


def prefill(params, tokens, cfg, cache, *, prefix_embeds=None, **_):
    """Fill the cache with the prompt; returns (last-token logits, cache).

    An int8 cache takes the keys and values cast, unscaled, as the
    reference's prefill writes them."""
    x = _inputs(params, tokens, cfg, prefix_embeds)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)[None]
    kv = []
    for i, lp in enumerate(params["layers"]):
        x = block(lp, x, cfg, positions, kv_out=kv, i=i)
    write_prompt(cache, torch.stack([k for k, _ in kv]),
                 torch.stack([v for _, v in kv]), S)
    return L.head_logits(params, x[:, -1:], cfg), cache


def decode_step(params, token, cache, cfg, **_):
    """One decode step: token (B,) -> (logits (B, V), cache).

    Handles both bfloat16 and int8-quantized caches (detected by the
    presence of ``k_scale``)."""
    dt = L.cdtype(cfg)
    x = L.embed(params, token, cfg)[:, None, :]                # (B,1,d)
    pos = cache["len"]
    slot = min(pos, cache["k"].shape[2] - 1)
    positions = torch.full((1, 1), pos, device=x.device)
    quant = "k_scale" in cache
    for i, lp in enumerate(params["layers"]):
        kc, vc = cache["k"][i], cache["v"][i]
        hn = L.rms_norm(x, lp["ln_attn"], cfg.norm_eps)
        q, k, v = L.qkv_proj(lp["attn"], hn, cfg, positions,
                             cfg.layer_rope(i))
        if quant:
            ks_s, vs_s = cache["k_scale"][i], cache["v_scale"][i]
            kq, k_sc = _kv_quantize(k)
            vq, v_sc = _kv_quantize(v)
            kc[:, slot] = kq[:, 0]
            vc[:, slot] = vq[:, 0]
            ks_s[:, slot] = k_sc[:, 0]
            vs_s[:, slot] = v_sc[:, 0]
            k_full = _kv_dequantize(kc, ks_s, dt)
            v_full = _kv_dequantize(vc, vs_s, dt)
        else:
            kc[:, slot] = k[:, 0].to(kc.dtype)
            vc[:, slot] = v[:, 0].to(vc.dtype)
            k_full, v_full = kc, vc
        o = L.attention_decode(q, k_full, v_full, pos + 1,
                               window=cfg.layer_window(i))
        x = x + _post(lp, "ln_attn_post", L.attn_out(lp["attn"], o, cfg, hn),
                      cfg)
        hn = L.rms_norm(x, lp["ln_mlp"], cfg.norm_eps)
        x = x + _post(lp, "ln_mlp_post", _ffn(lp, hn, cfg), cfg)
    cache["len"] = pos + 1
    return L.head_logits(params, x, cfg)[:, 0], cache
