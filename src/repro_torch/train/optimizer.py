"""AdamW with linear-warmup cosine decay and global-norm clipping.

Port of ``repro.train.optimizer``, in the reference's arithmetic order:
the clip scale from the global norm, the bias corrections, ``mh /
(sqrt(vh) + eps)``, decoupled weight decay on leaves of two or more
dimensions only, float32 ``m`` and ``v``.  The reference stacks a
model's layers along a leading axis, so a per-layer vector (a norm's
scale, a bias) is a matrix there and decays; a ``Params`` tree counts
its leaves' dimensions the same way (``Params.ref_ndims``).  Not ``torch.optim.AdamW``:
its operation order differs, and the schedule and clip live outside it.

The optimizer state mirrors the parameters: ``m`` and ``v`` are
:class:`~repro_torch.models.layers.Params` trees of the same structure,
so ``params.parameters()``, ``m.parameters()`` and ``v.parameters()``
line up leaf for leaf.  :func:`adamw_update` writes the new values into
the parameters and the state in place.
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def leaves(tree) -> list:
    """The tensors of a parameter tree (a module's parameters, in
    registration order) or of a sequence."""
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters())
    return list(tree)


def ref_ndims(tree) -> list:
    """Each leaf's dimensions as the reference's optimizer sees them."""
    if hasattr(tree, "ref_ndims"):
        return tree.ref_ndims()
    return [p.ndim for p in leaves(tree)]


def schedule(step, cfg: OptConfig) -> torch.Tensor:
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def init_opt_state(params) -> dict:
    """Zero ``m`` and ``v`` (float32) in the parameters' tree, count 0."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return {"m": params.map(zeros), "v": params.map(zeros),
            "count": torch.zeros((), dtype=torch.int32,
                                 device=params.device)}


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves(tree)))


@torch.no_grad()
def adamw_update(grads, opt_state, params, cfg: OptConfig):
    """One AdamW step; returns (params, opt_state, metrics).

    ``grads`` lines up with ``params``' leaves (a sequence, or a tree of
    the same structure).  ``params`` and the state's ``m``/``v`` are
    updated in place and returned; ``count`` is replaced.  ``metrics``
    holds the pre-clip ``grad_norm`` and this step's ``lr``."""
    count = opt_state["count"] + 1
    flat_g = leaves(grads)
    flat_p = leaves(params)
    flat_m = leaves(opt_state["m"])
    flat_v = leaves(opt_state["v"])
    if not len(flat_g) == len(flat_p) == len(flat_m) == len(flat_v):
        raise ValueError(f"{len(flat_g)} gradients for {len(flat_p)} "
                         f"parameters and {len(flat_m)}/{len(flat_v)} "
                         f"moments")
    gnorm = global_norm(flat_g)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    lr = schedule(count, cfg)
    cf = count.to(torch.float32)
    b1c = 1.0 - cfg.b1 ** cf
    b2c = 1.0 - cfg.b2 ** cf
    for g, m, v, p, nd in zip(flat_g, flat_m, flat_v, flat_p,
                              ref_ndims(params)):
        g = g.float() * scale
        m.mul_(cfg.b1).add_((1.0 - cfg.b1) * g)
        gg = (1.0 - cfg.b2) * g
        v.mul_(cfg.b2).add_(gg.mul_(g))
        step = (m / b1c).div_((v / b2c).sqrt_().add_(cfg.eps))
        if nd >= 2:          # decoupled weight decay on matrices only
            step.add_(cfg.weight_decay * p.float())
        if p.dtype == torch.float32:
            p.sub_(step.mul_(lr))
        else:
            p.copy_((p.float() - lr * step).to(p.dtype))
    opt_state = dict(opt_state, count=count)
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
