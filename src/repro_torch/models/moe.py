"""Mixture-of-Experts FFN with capacity-bounded scatter dispatch.

Port of ``repro.models.moe``.  Routing is top-k over float32 router
logits in ``lax.top_k``'s order (descending, the lower expert index
first among equals); each assignment's rank within its expert comes from
a cumulative one-hot count over assignments in (token, k) order, and an
assignment ranked at or past the capacity C is dropped.  Kept tokens are
written into an (E, C, d) buffer (at most one per slot), the experts run
as batched matmuls, and each token's k weighted outputs are summed in
assignment order in the compute dtype, as the reference's scatter-add
does.  Shared experts are always-on dense MLPs.

On a device mesh the routing, the buffer's scatter and the outputs'
gather have no DTensor sharding rule: the tokens are gathered whole
(``spmd.gathered``) and every rank routes all of them, as the
reference's global capacity ranks them; the (E, C, d) buffer is then
split over the mesh dims that shard the experts' E dim (expert
parallelism: each rank runs its experts), and the experts' outputs
gathered whole again for the combine.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import layers as L
from . import spmd


def init_moe(init: L.Init, cfg) -> dict:
    d, ff, E = cfg.d_model, cfg.e_ff, cfg.experts
    p = {
        "router": init.dense((d, E), scale=0.02),
        "we_gate": init.dense((E, d, ff)),
        "we_up": init.dense((E, d, ff)),
        "we_down": init.dense((E, ff, d)),
    }
    if cfg.n_shared_experts:
        p["shared"] = L.init_mlp(init, d, ff * cfg.n_shared_experts)
    return p


def capacity(cfg, n_tokens: int) -> int:
    c = int(math.ceil(cfg.top_k * n_tokens / cfg.experts
                      * cfg.capacity_factor))
    return max(8, -(-c // 8) * 8)   # pad to 8, as the reference does


def top_k(logits: torch.Tensor, k: int):
    """``lax.top_k``: the k largest along the last axis, descending, the
    lower index first among equal values."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_block(p: L.Params, x: torch.Tensor, cfg) -> torch.Tensor:
    """x (B, S, d) -> (B, S, d)."""
    B, S, d = x.shape
    T = B * S
    E, k = cfg.experts, cfg.top_k
    C = capacity(cfg, T)
    dt = x.dtype
    dev = x.device
    xf = x.reshape(T, d)
    xw, mesh = spmd.gathered(xf)          # every token, on a mesh too

    logits = xw.float() @ spmd.gathered(p["router"])[0].float()
    topv, topi = top_k(logits, k)                          # (T, k)
    gates = torch.softmax(topv, dim=-1)                    # (T, k)

    eid = topi.reshape(-1)                                 # (T*k,)
    tid = torch.arange(T, device=dev).repeat_interleave(k)
    onehot = F.one_hot(eid, E)                             # (T*k, E)
    pos = (onehot.cumsum(0) * onehot).sum(-1) - 1          # rank in expert
    keep = (pos < C) & (pos >= 0)
    pos_c = pos.clamp(0, C - 1)

    # dropped assignments go to a spare slot C that is cut off again
    buf = torch.zeros((E, C + 1, d), dtype=dt, device=dev)
    buf[eid, torch.where(keep, pos_c, C)] = xw[tid]
    buf = _experts_split(buf[:, :C], mesh, p["we_gate"])

    h = L.ACTS[cfg.act](torch.einsum("ecd,edf->ecf", buf,
                                     p.w("we_gate", dt)))
    h = h * torch.einsum("ecd,edf->ecf", buf, p.w("we_up", dt))
    out_buf, _ = spmd.gathered(torch.einsum("ecf,efd->ecd", h,
                                         p.w("we_down", dt)))

    gathered = out_buf[eid, pos_c] * keep[:, None].to(dt)  # (T*k, d)
    w = gates.reshape(-1)[:, None].to(dt)
    contrib = (gathered * w).reshape(T, k, d)
    y = contrib[:, 0]
    for j in range(1, k):                                  # assignment order
        y = y + contrib[:, j]
    y = spmd.replicated(y, mesh).reshape(B, S, d)

    if cfg.n_shared_experts:
        y = y + L.mlp(p["shared"], x, cfg.act)
    return y


def _experts_split(buf, mesh, w):
    """The (E, C, d) buffer on ``mesh`` split over the mesh dims that
    shard the expert weight ``w``'s E dim; as it is without a mesh."""
    if mesh is None:
        return buf
    from torch.distributed.tensor import Replicate, Shard
    pl = [Shard(0) if p == Shard(0) else Replicate() for p in w.placements]
    return spmd.replicated(buf, mesh).redistribute(mesh, pl)
