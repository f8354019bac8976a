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

``cfg.router == "sigmoid"`` takes another path, the afmoe block's
(:func:`sigmoid_block`): scores sigmoid(x W_r) in float32 over every
expert, the top k chosen on score + selection bias, the weights the
chosen scores over their sum times ``route_scale``, no capacity and no
dropped assignment.  Only the experts this device holds (``cfg.held``)
are computed, as one grouped product over them
(``torch._grouped_mm`` on the card; a loop over the held experts on the
CPU); what the other experts would add is left to the devices that hold
them.  The selection bias is a float32 buffer beside the layer's
parameters (no gradient, outside AdamW); each train step's assignment
counts over every expert gather in a second buffer, and
:func:`update_bias` moves the bias by them after the step.

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
from ..obs import metrics as obs_metrics
from ..obs import trace


def init_moe(init: L.Init, cfg) -> dict:
    d, ff, E = cfg.d_model, cfg.e_ff, cfg.experts
    n = len(cfg.held) if cfg.router == "sigmoid" else E   # experts here
    p = {
        "router": init.dense((d, E), scale=0.02),
        "we_gate": init.dense((n, d, ff)),
        "we_up": init.dense((n, d, ff)),
        "we_down": init.dense((n, ff, d)),
    }
    if cfg.n_shared_experts:
        p["shared"] = L.init_mlp(init, d, ff * cfg.n_shared_experts)
    return p


def add_bias_state(tree: L.Params, cfg) -> None:
    """The sigmoid router's state on a layer's ``moe`` tree: the
    selection bias and the step's assignment counts, one per expert."""
    dev = tree.router.device
    tree.register_buffer("bias", torch.zeros(cfg.experts, device=dev))
    tree.register_buffer("counts", torch.zeros(cfg.experts, device=dev))


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
    if cfg.router == "sigmoid":
        return sigmoid_block(p, x, cfg)
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


def _counting() -> bool:
    """Whether this forward's assignments count towards the bias: a
    train step's forward, not its recomputation inside the backward."""
    return torch.is_grad_enabled() and \
        torch._C._current_graph_task_id() == -1


def route(p: L.Params, x: torch.Tensor, cfg):
    """x (T, d) -> (chosen experts (T, k), their weights (T, k) float32)."""
    scores = torch.sigmoid(x.float() @ p.w("router", torch.float32))
    _, chosen = top_k(scores + p["bias"], cfg.top_k)
    w = torch.gather(scores, 1, chosen)
    return chosen, w / w.sum(dim=-1, keepdim=True) * cfg.route_scale


def grouped(a: torch.Tensor, w: torch.Tensor, offs: torch.Tensor,
            keep: torch.Tensor):
    """Rows ``a`` (N, K) times the per-group matrices ``w`` (G, K, M),
    group g being rows ``offs[g-1]:offs[g]``; the rows past ``offs[-1]``
    (``keep`` (N, 1) False) come out 0.  The card's grouped product
    leaves those rows unspecified, so they are masked by selection: no
    product, forward or backward, reads them."""
    if a.is_cuda:
        return torch.where(keep, torch._grouped_mm(a, w, offs=offs), 0)
    with trace.wait("wait.moe.offsets"):
        ends = offs.tolist()
    out = a.new_zeros(a.shape[0], w.shape[-1])
    start = 0
    for g, end in enumerate(ends):
        out[start:end] = a[start:end] @ w[g]
        start = end
    return out


def sigmoid_block(p: L.Params, x: torch.Tensor, cfg) -> torch.Tensor:
    """The afmoe layer on x (B, S, d): the held experts' part of the
    routed sum, plus the shared expert, with no capacity."""
    obs_metrics.PROCESS.count("moe.calls")
    B, S, d = x.shape
    T, k, dt = B * S, cfg.top_k, x.dtype
    held = cfg.held
    xf = x.reshape(T, d)
    with trace.span("moe.route"):
        chosen, w = route(p, xf, cfg)
        eid = chosen.reshape(-1)                           # (T*k,)
        if _counting():
            p["counts"].add_(torch.bincount(eid, minlength=cfg.experts)
                             .float())
    with trace.span("moe.dispatch"):
        # held experts as groups 0 .. H-1, every other assignment last
        local = eid - held.start
        mine = (local >= 0) & (local < len(held))
        group = torch.where(mine, local, len(held))
        order = torch.argsort(group, stable=True)
        offs = torch.cumsum(torch.bincount(group, minlength=len(held) + 1),
                            0)[:len(held)].to(torch.int32)
        keep = mine[order][:, None]
        rows = torch.where(keep, xf[order // k], 0)        # (T*k, d)
    with trace.span("moe.experts"):
        h = L.ACTS[cfg.act](grouped(rows, p.w("we_gate", dt), offs, keep)) \
            * grouped(rows, p.w("we_up", dt), offs, keep)
        out = grouped(h, p.w("we_down", dt), offs, keep)
    with trace.span("moe.combine"):
        # rows of other devices' experts are 0 here, so add nothing
        out = out.float() * w.reshape(-1)[order][:, None]
        y = out.new_zeros(T, d).index_add_(0, order // k, out)
        y = y.to(dt).reshape(B, S, d)
    if cfg.n_shared_experts:
        y = y + L.mlp(p["shared"], x, cfg.act)
    return y


@torch.no_grad()
def update_bias(p: L.Params, rate: float) -> None:
    """The load-balancing step (DeepSeek-V3, arXiv:2412.19437 §2.1.2):
    b += rate * sign(mean(c) - c) over the step's counts c, which are
    then cleared; on the device, no wait."""
    c = p["counts"]
    p["bias"].add_(torch.sign(c.mean() - c), alpha=rate)
    c.zero_()
