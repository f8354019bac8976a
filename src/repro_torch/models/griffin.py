"""Griffin / RecurrentGemma (arXiv:2402.19427): RG-LRU recurrent blocks
interleaved with local sliding-window MQA attention (pattern 2 recurrent :
1 attention), GeGLU MLPs.

Port of ``repro.models.griffin``.  RG-LRU: a_t = exp(-c softplus(Lam)
r_t); h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t x_t), in float32.  The
reference evaluates the recurrence with ``associative_scan``; the port
runs it as a loop over time in float32 (the same values up to rounding).
The local-attention decode cache is a ring of ``window`` slots (2,048
unless the config sets one) with absolute-position tags, -1 where empty;
prefill fills the ring with the prompt's last ``window`` keys and values.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from .. import resolve_device
from . import layers as L
from . import spmd

_LRU_C = 8.0


def lru_width(cfg) -> int:
    return cfg.lru_width or cfg.d_model


def layer_kind(cfg, idx: int) -> str:
    pat = cfg.block_pattern or ("rec", "rec", "attn")
    return pat[idx % len(pat)]


def init_block(init: L.Init, cfg, idx: int) -> dict:
    d = cfg.d_model
    w = lru_width(cfg)
    p = {"ln_mix": init.zeros((d,)),
         "ln_mlp": init.zeros((d,)),
         "mlp": L.init_mlp(init, d, cfg.d_ff)}
    if layer_kind(cfg, idx) == "attn":
        p["attn"] = L.init_attn(init, cfg)
    else:
        p.update({
            "w_x": init.dense((d, w)),                 # recurrent branch
            "w_gate": init.dense((d, w)),              # GeLU gate branch
            "conv": init.normal((cfg.conv_width, w), 0.1),
            "w_rg": init.dense((w, w), scale=0.02),    # recurrence gate
            "w_ig": init.dense((w, w), scale=0.02),    # input gate
            "lam": init.full((w,), 1.0),               # softplus(lam)~1.3
            "w_y": init.dense((w, d)),
        })
    return p


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------

def _lru_coeffs(p, x):
    """x (B,S,w) -> (a, b) of the recurrence h = a*h_prev + b, float32."""
    x32 = x.float()
    r = torch.sigmoid(x32 @ p["w_rg"].float())
    i = torch.sigmoid(x32 @ p["w_ig"].float())
    log_a = -_LRU_C * F.softplus(p["lam"]) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * (i * x32)
    return a, b


def lru_scan(a, b):
    """h_t = a_t h_{t-1} + b_t over axis 1 from h_0 = 0, float32; returns
    every h_t, (B, S, w).  On a mesh the loop runs on each rank's rows
    (``spmd.batch_local``)."""
    if isinstance(b, DTensor):
        return spmd.batch_local(lru_scan, (a, b))
    h = torch.zeros_like(b[:, 0])
    hs = []
    for t in range(b.shape[1]):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1)


def rg_lru_scan(p, x):
    a, b = _lru_coeffs(p, x)
    return lru_scan(a, b).to(x.dtype)          # h_t with h_0 prior = 0


def rg_lru_step(p, x1, h_prev):
    """One decode step: x1 (B,1,w), h_prev (B,w) -> (y (B,1,w), h)."""
    a, b = _lru_coeffs(p, x1)
    h = a[:, 0] * h_prev + b[:, 0]
    return h[:, None, :].to(x1.dtype), h


def causal_conv(p, x, state=None):
    """Depthwise causal conv of width cw. state: (B, cw-1, w) history."""
    cw = p["conv"].shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], cw - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    S = x.shape[1]
    conv = p["conv"].to(x.dtype)
    out = xp[:, 0:S] * conv[0]
    for i in range(1, cw):
        out = out + xp[:, i:i + S] * conv[i]
    new_state = xp[:, -(cw - 1):] if cw > 1 else pad
    return out, new_state


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _rec_inputs(p, x):
    dt = x.dtype
    xi = x @ p.w("w_x", dt)
    gate = F.gelu((x @ p.w("w_gate", dt)).float(),
                  approximate="tanh").to(dt)
    return xi, gate


def rec_mix(p, x, cfg, conv_state=None, lru_state=None, decode=False):
    xi, gate = _rec_inputs(p, x)
    xi, conv_state = causal_conv(p, xi, conv_state)
    if decode:
        y, lru_state = rg_lru_step(p, xi, lru_state)
    else:
        y = rg_lru_scan(p, xi)
    out = (y * gate) @ p.w("w_y", x.dtype)
    return out, conv_state, lru_state


def _mlp_tail(p, x, cfg):
    h = L.rms_norm(x, p["ln_mlp"], cfg.norm_eps)
    return x + L.mlp(p["mlp"], h, "gelu")


def block_forward(p, x, cfg, idx, positions):
    h = L.rms_norm(x, p["ln_mix"], cfg.norm_eps)
    if layer_kind(cfg, idx) == "attn":
        q, k, v = L.qkv_proj(p["attn"], h, cfg, positions)
        o = L.attention(q, k, v, causal=True, window=cfg.window)
        mix = L.attn_out(p["attn"], o, cfg)
    else:
        mix, _, _ = rec_mix(p, h, cfg)
    return _mlp_tail(p, x + mix, cfg)


def param_tree(cfg, init: L.Init) -> dict:
    return {
        "embed": init.embed(cfg.padded_vocab, cfg.d_model),
        "blocks": [init_block(init, cfg, i) for i in range(cfg.n_layers)],
        "ln_f": init.zeros((cfg.d_model,)),
        "head": init.dense((cfg.d_model, cfg.padded_vocab)),
    }


def init_params(cfg, seed: int = 0, device=None) -> L.Params:
    return L.Params(param_tree(cfg, L.make_init(device, seed)))


def forward(params, tokens, cfg, *, remat=False, **_):
    x = L.embed(params, tokens, cfg)
    positions = torch.arange(tokens.shape[1], device=x.device)[None]
    for i, bp in enumerate(params["blocks"]):
        x = L.constrain_acts(L.remat_call(block_forward, remat, bp, x, cfg,
                                          i, positions))
    return L.head_logits(params, x, cfg)


# ---------------------------------------------------------------------------
# Serving: ring-buffer window cache + recurrent states
# ---------------------------------------------------------------------------

def init_cache(cfg, batch, max_len=0, dtype=torch.bfloat16, device=None):
    dev = resolve_device(device)
    w = lru_width(cfg)
    win = cfg.window or 2048
    states = []
    for i in range(cfg.n_layers):
        if layer_kind(cfg, i) == "attn":
            states.append({
                "k": torch.zeros((batch, win, cfg.n_kv, cfg.hd), dtype=dtype,
                                 device=dev),
                "v": torch.zeros((batch, win, cfg.n_kv, cfg.hd), dtype=dtype,
                                 device=dev),
                "pos": torch.full((win,), -1, dtype=torch.int32, device=dev),
            })
        else:
            states.append({
                "conv": torch.zeros((batch, cfg.conv_width - 1, w),
                                    dtype=dtype, device=dev),
                "h": torch.zeros((batch, w), device=dev),
            })
    return {"states": states, "len": 0}


def _attn_decode_ring(p, h, st, cfg, pos):
    win = st["k"].shape[1]
    positions = torch.full((1, 1), pos, device=h.device)
    q, k, v = L.qkv_proj(p["attn"], h, cfg, positions)
    slot = pos % win
    st["k"][:, slot] = k[:, 0].to(st["k"].dtype)
    st["v"][:, slot] = v[:, 0].to(st["v"].dtype)
    st["pos"][slot] = pos
    # attend over the valid ring slots
    q = spmd.whole_dim(q, 2)
    B, _, H, D = q.shape
    KV = st["k"].shape[2]
    qg = q.reshape(B, 1, KV, H // KV, D).float()
    s = torch.einsum("bsgrd,btgd->bgrst", qg,
                     st["k"].float()) / math.sqrt(D)
    s = s.masked_fill(~(st["pos"] >= 0), L.MASK_VALUE)
    pmax = torch.softmax(s, dim=-1)
    o = torch.einsum("bgrst,btgd->bsgrd", pmax, st["v"].float())
    o = o.reshape(B, 1, H, D).to(h.dtype)
    return L.attn_out(p["attn"], o, cfg)


def _ring_put(st, slots, k, v, pos):
    """Write keys/values (B, n, KV, hd) and their positions at ring
    ``slots``; a ``DTensor`` ring is written on each rank's rows
    (``spmd.batch_local``) and its tags on a whole copy: DTensor has no
    rule for an index write."""
    if not isinstance(st["k"], DTensor):
        st["k"][:, slots] = k.to(st["k"].dtype)
        st["v"][:, slots] = v.to(st["v"].dtype)
        st["pos"][slots] = pos
        return

    def put(kc, vc, kn, vn):
        kc, vc = kc.clone(), vc.clone()
        kc[:, slots] = kn.to(kc.dtype)
        vc[:, slots] = vn.to(vc.dtype)
        return kc, vc
    st["k"], st["v"] = spmd.batch_local(put, (st["k"], st["v"], k, v))
    tags, mesh = spmd.gathered(st["pos"])
    tags = tags.clone()
    tags[slots] = pos.to(tags.dtype)
    st["pos"] = spmd.replicated(tags, mesh)


def decode_step(params, token, cache, cfg, **_):
    x = L.embed(params, token, cfg)[:, None, :]
    pos = cache["len"]
    for i, bp in enumerate(params["blocks"]):
        st = cache["states"][i]
        h = L.rms_norm(x, bp["ln_mix"], cfg.norm_eps)
        if layer_kind(cfg, i) == "attn":
            mix = _attn_decode_ring(bp, h, st, cfg, pos)
        else:
            mix, conv, st["h"] = rec_mix(bp, h, cfg, conv_state=st["conv"],
                                         lru_state=st["h"], decode=True)
            st["conv"] = conv.to(st["conv"].dtype)
        x = _mlp_tail(bp, x + mix, cfg)
    cache["len"] = pos + 1
    return L.head_logits(params, x, cfg)[:, 0], cache


def prefill(params, tokens, cfg, cache, **_):
    """Prompt processing: parallel forms + state absorption."""
    x = L.embed(params, tokens, cfg)
    S = tokens.shape[1]
    positions = torch.arange(S, device=x.device)[None]
    for i, bp in enumerate(params["blocks"]):
        st = cache["states"][i]
        h = L.rms_norm(x, bp["ln_mix"], cfg.norm_eps)
        if layer_kind(cfg, i) == "attn":
            q, k, v = L.qkv_proj(bp["attn"], h, cfg, positions)
            o = L.attention(q, k, v, causal=True, window=cfg.window)
            mix = L.attn_out(bp["attn"], o, cfg)
            win = st["k"].shape[1]
            take = min(win, S)
            # absorb the last `take` keys/values at their ring slots
            pos_tail = torch.arange(S - take, S, dtype=torch.int32,
                                    device=x.device)
            slots = (pos_tail % win).long()
            _ring_put(st, slots, k[:, -take:], v[:, -take:], pos_tail)
        else:
            xi, gate = _rec_inputs(bp, h)
            xi, conv_state = causal_conv(bp, xi, None)
            a, b = _lru_coeffs(bp, xi)
            hs = lru_scan(a, b)
            st["conv"] = conv_state.to(st["conv"].dtype)
            st["h"] = hs[:, -1]
            mix = (hs.to(x.dtype) * gate) @ bp.w("w_y", x.dtype)
        x = _mlp_tail(bp, x + mix, cfg)
    cache["len"] = S
    return L.head_logits(params, x[:, -1:], cfg), cache
