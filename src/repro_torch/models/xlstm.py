"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory) and sLSTM
(scalar memory, true recurrence), alternating per config.

Port of ``repro.models.xlstm``.  mLSTM has two exact forms: the parallel
decay-masked quadratic form (log-space, a -inf upper triangle, stabilised
by the row max) for training and the forward pass, and the one-step
recurrent form C_t = f C_{t-1} + i v k^T for decode; prefill replays the
recurrent form token by token to build the state.  sLSTM is a loop over
time in float32 with per-head recurrent weights.  States start with
``m = -1e30``.  The cache is a list of per-block states plus ``len``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import resolve_device
from . import layers as L
from . import spmd


def _inner(cfg) -> int:
    return int(cfg.proj_factor * cfg.d_model)


def is_slstm(cfg, layer_idx: int) -> bool:
    return cfg.slstm_every > 0 and (layer_idx % cfg.slstm_every
                                    == cfg.slstm_every - 1)


def init_block(init: L.Init, cfg, layer_idx: int) -> dict:
    d = cfg.d_model
    di = _inner(cfg)
    H = cfg.n_heads
    hd = di // H
    p = {
        "ln": init.zeros((d,)),
        "w_up": init.dense((d, 2 * di)),
        "w_down": init.dense((di, d)),
        "w_q": init.dense((di, di)),
        "w_k": init.dense((di, di)),
        "w_v": init.dense((di, di)),
        "w_i": init.dense((di, H), scale=0.02),
        "b_i": init.zeros((H,)),
        "w_f": init.dense((di, H), scale=0.02),
        "b_f": init.full((H,), 3.0),               # forget-open init
        "ln_inner": init.zeros((di,)),
    }
    if is_slstm(cfg, layer_idx):
        p["r_z"] = init.dense((H, hd, hd))
        p["w_o"] = init.dense((di, di))
    return p


# ---------------------------------------------------------------------------
# mLSTM core
# ---------------------------------------------------------------------------

def _gates(p, xi):
    """log-space input/forget gates: (B,S,H)."""
    x32 = xi.float()
    li = x32 @ p["w_i"].float() + p["b_i"]                     # log i
    lf = spmd.local_apply(F.logsigmoid, x32 @ p["w_f"].float() + p["b_f"])
    return li, lf


def mlstm_parallel(p, xi, cfg):
    """Stabilised decay-masked quadratic form. xi: (B,S,di).  On a mesh
    the form runs on each rank's rows (``spmd.batch_local``)."""
    B, S, di = xi.shape
    H = cfg.n_heads
    hd = di // H
    dt = xi.dtype
    q = L.split_heads(xi @ p.w("w_q", dt), H, hd)
    k = L.split_heads(xi @ p.w("w_k", dt), H, hd) / math.sqrt(hd)
    v = L.split_heads(xi @ p.w("w_v", dt), H, hd)
    li, lf = _gates(p, xi)                                     # (B,S,H)
    h = spmd.batch_local(_mlstm_form, (q, k, v, li, lf))
    return L.merge_heads(h).to(dt)


def _mlstm_form(q, k, v, li, lf):
    S = q.shape[1]
    Fc = torch.cumsum(lf, dim=1)                               # log prod f
    # log decay D[t,s] = F_t - F_s + li_s  (s <= t)
    logD = Fc[:, :, None, :] - Fc[:, None, :, :] + li[:, None, :, :]
    tri = torch.tril(torch.ones((S, S), dtype=torch.bool, device=q.device))
    logD = logD.masked_fill(~tri[None, :, :, None], float("-inf"))
    m = logD.amax(dim=2, keepdim=True)                         # (B,T,1,H)
    D = torch.exp(logD - m)                                    # stabilised
    qk = torch.einsum("bthd,bshd->btsh", q.float(), k.float())
    Ct = qk * D
    norm = torch.maximum(torch.abs(Ct.sum(dim=2)), torch.exp(-m[:, :, 0, :]))
    h = torch.einsum("btsh,bshd->bthd", Ct, v.float())
    return h / norm[..., None]


def mlstm_decode(p, xi, state, cfg):
    """One-step recurrent form. xi: (B,1,di); state: dict(C,n,m).  On a
    mesh the step runs on each rank's rows (``spmd.batch_local``)."""
    B, _, di = xi.shape
    H = cfg.n_heads
    hd = di // H
    dt = xi.dtype
    q = L.split_heads(xi @ p.w("w_q", dt), H, hd).reshape(B, H, hd).float()
    k = (L.split_heads(xi @ p.w("w_k", dt), H, hd).reshape(B, H, hd)
         / math.sqrt(hd)).float()
    v = L.split_heads(xi @ p.w("w_v", dt), H, hd).reshape(B, H, hd).float()
    li, lf = _gates(p, xi)
    h, C, n, m = spmd.batch_local(
        _mlstm_step, (q, k, v, li[:, 0], lf[:, 0], state["m"], state["C"],
                      state["n"]))
    return L.merge_heads(h).reshape(B, 1, di).to(dt), {"C": C, "n": n,
                                                       "m": m}


def _mlstm_step(q, k, v, li, lf, m_prev, C_prev, n_prev):
    m = torch.maximum(lf + m_prev, li)
    f = torch.exp(lf + m_prev - m)
    i = torch.exp(li - m)
    C = f[..., None, None] * C_prev + i[..., None, None] * (
        v[..., :, None] * k[..., None, :])                     # (B,H,hd,hd)
    n = f[..., None] * n_prev + i[..., None] * k
    num = torch.einsum("bhij,bhj->bhi", C, q)
    den = torch.maximum(torch.abs(torch.einsum("bhj,bhj->bh", n, q)),
                        torch.exp(-m))
    return num / den[..., None], C, n, m


def mlstm_init_state(cfg, batch, device):
    di = _inner(cfg)
    H = cfg.n_heads
    hd = di // H
    return {"C": torch.zeros((batch, H, hd, hd), device=device),
            "n": torch.zeros((batch, H, hd), device=device),
            "m": torch.full((batch, H), -1e30, device=device)}


# ---------------------------------------------------------------------------
# sLSTM core (a loop over time; recurrent weights per head)
# ---------------------------------------------------------------------------

def slstm_scan(p, xi, cfg, state=None):
    """xi (B,S,di) -> (B,S,di); optionally continue from ``state``."""
    B, S, di = xi.shape
    H = cfg.n_heads
    hd = di // H
    z_in = L.split_heads(xi @ p.w("w_v", xi.dtype), H, hd)
    o_in = L.split_heads(xi @ p.w("w_o", xi.dtype), H, hd)
    li, lf = _gates(p, xi)
    if state is None:
        state = slstm_init_state(cfg, B, xi.device)
    # on a mesh the loop runs on each rank's rows (spmd.batch_local)
    out, c, n, m, h = spmd.batch_local(
        _slstm_loop, (z_in, o_in, li, lf, state["c"], state["n"],
                      state["m"], state["h"]), (p["r_z"],))
    return out.to(xi.dtype), {"c": c, "n": n, "m": m, "h": h}


def _slstm_loop(z_in, o_in, li, lf, c, n, m, h, r_z):
    """The sLSTM recurrence over time; returns (hs (B,S,di), c, n, m, h)."""
    B, S, H, hd = z_in.shape
    rz = r_z.float()
    hs = []
    for t in range(S):
        z = torch.tanh(z_in[:, t].float()
                       + torch.einsum("bhi,hij->bhj", h, rz))
        m_new = torch.maximum(lf[:, t] + m, li[:, t])
        f = torch.exp(lf[:, t] + m - m_new)
        i = torch.exp(li[:, t] - m_new)
        c = f[..., None] * c + i[..., None] * z
        n = f[..., None] * n + i[..., None]
        h = torch.sigmoid(o_in[:, t].float()) * c / torch.clamp(n, min=1e-6)
        m = m_new
        hs.append(h)
    return torch.stack(hs, dim=1).reshape(B, S, H * hd), c, n, m, h


def slstm_init_state(cfg, batch, device):
    di = _inner(cfg)
    H = cfg.n_heads
    hd = di // H
    return {"c": torch.zeros((batch, H, hd), device=device),
            "n": torch.zeros((batch, H, hd), device=device),
            "m": torch.full((batch, H), -1e30, device=device),
            "h": torch.zeros((batch, H, hd), device=device)}


# ---------------------------------------------------------------------------
# Full blocks / model
# ---------------------------------------------------------------------------

def _up(p, x, cfg):
    h = L.rms_norm(x, p["ln"], cfg.norm_eps)
    return torch.chunk(h @ p.w("w_up", x.dtype), 2, dim=-1)


def _down(p, x, core, z, cfg):
    core = L.rms_norm(core, p["ln_inner"], cfg.norm_eps)
    return x + (core * F.silu(z)) @ p.w("w_down", x.dtype)


def block_forward(p, x, cfg, layer_idx):
    """Training/forward form."""
    xi, z = _up(p, x, cfg)
    if is_slstm(cfg, layer_idx):
        core, _ = slstm_scan(p, xi, cfg)
    else:
        core = mlstm_parallel(p, xi, cfg)
    return _down(p, x, core, z, cfg)


def block_decode(p, x, state, cfg, layer_idx):
    xi, z = _up(p, x, cfg)
    if is_slstm(cfg, layer_idx):
        core, state = slstm_scan(p, xi, cfg, state=state)
    else:
        core, state = mlstm_decode(p, xi, state, cfg)
    return _down(p, x, core, z, cfg), state


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
    for i, bp in enumerate(params["blocks"]):
        x = L.constrain_acts(L.remat_call(block_forward, remat, bp, x, cfg,
                                          i))
    return L.head_logits(params, x, cfg)


def init_cache(cfg, batch, max_len=0, dtype=torch.bfloat16, device=None):
    """Recurrent state per block: O(1) in sequence length."""
    dev = resolve_device(device)
    states = [slstm_init_state(cfg, batch, dev) if is_slstm(cfg, i)
              else mlstm_init_state(cfg, batch, dev)
              for i in range(cfg.n_layers)]
    return {"states": states, "len": 0}


def prefill(params, tokens, cfg, cache, **_):
    """Sequential state build-up via the recurrent forms (exact)."""
    x = L.embed(params, tokens, cfg)
    S = tokens.shape[1]
    for i, bp in enumerate(params["blocks"]):
        xi, z = _up(bp, x, cfg)
        st = cache["states"][i]
        if is_slstm(cfg, i):
            core, st = slstm_scan(bp, xi, cfg, state=st)
        else:
            cores = []
            for t in range(S):
                c, st = mlstm_decode(bp, xi[:, t:t + 1], st, cfg)
                cores.append(c)
            core = torch.cat(cores, dim=1)
        x = _down(bp, x, core, z, cfg)
        cache["states"][i] = st
    cache["len"] = S
    return L.head_logits(params, x[:, -1:], cfg), cache


def decode_step(params, token, cache, cfg, **_):
    x = L.embed(params, token, cfg)[:, None, :]
    for i, bp in enumerate(params["blocks"]):
        x, cache["states"][i] = block_decode(bp, x, cache["states"][i],
                                             cfg, i)
    cache["len"] += 1
    return L.head_logits(params, x, cfg)[:, 0], cache
