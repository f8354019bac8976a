"""Train steps.

Port of ``repro.train.loop``:

* ``make_train_step`` — loss, gradients (``backward`` through the
  model's ``loss_fn``), AdamW.  ``accum > 1`` sums the gradients of
  ``accum`` microbatches and divides, as the reference's scan does.  With
  a process group of more than one rank (data parallelism, each rank on
  its rows of the global batch), gradients and loss are averaged across
  ranks before the update, where the reference's SPMD partitioning
  inserts that all-reduce.  On a device mesh (parameters and moments
  ``DTensor``s, :func:`shard_train_state`; the batch a ``DTensor``
  sharded over the data axes, ``TokenPipeline.next(mesh=...)``) DTensor's
  sharding propagation inserts every collective, as GSPMD does for the
  reference: loss, gradients and the global norm come out whole.
* After the update, a sigmoid router's selection bias moves by the
  step's assignment counts (``models.moe.update_bias``: DeepSeek-V3's
  rule at rate ``cfg.bias_rate``), on the device; it is state outside
  AdamW, with no gradient and no decay.
* ``make_dp_compressed_step`` — the pure data-parallel step whose
  gradient all-reduce is the paper's Gamma quantizer with error feedback
  (``core.secure_agg``), over a ``torch.distributed`` process group
  where the reference uses ``shard_map`` over the ``data`` axis.

A train state is ``{"params": Params (trainable), "opt": {"m", "v",
"count"}, "step"}``; a step updates the parameters and moments in place
and returns the state with new ``count`` and ``step``.
"""
from __future__ import annotations

from typing import Callable

import contextlib
import gc

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from . import optimizer as opt_mod
from .. import resolve_device
from ..core import secure_agg
from ..launch.mesh import dp_world
from ..models import moe, registry
from ..obs import trace


def _grads(params) -> list:
    """Each leaf's gradient (zeros for a leaf the loss does not reach,
    as ``jax.grad`` gives), in the parameters' order; a ``DTensor``
    gradient at its parameter's placements (a partial sum is reduced)."""
    out = []
    for p in params.parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        if isinstance(g, DTensor) and g.placements != p.placements:
            g = g.redistribute(p.device_mesh, p.placements)
        out.append(g)
    return out


def is_sharded(params) -> bool:
    """Whether ``params`` lies on a device mesh (``DTensor`` leaves)."""
    return isinstance(next(params.parameters()), DTensor)


def _whole(t: torch.Tensor) -> torch.Tensor:
    """A metric as a plain tensor (a ``DTensor``'s full value)."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def _microbatch(v, accum: int, i: int):
    """Microbatch ``i`` of ``accum``: rows ``[i B / accum, (i + 1) B /
    accum)`` of a plain batch, as the reference's reshape and scan take
    them; of a ``DTensor`` batch, the same share of every rank's rows
    (no collective).  The step's gradient, a mean over microbatches of
    each one's mean, is the same when every row carries as many labels,
    as the pipeline's do."""
    if not isinstance(v, DTensor):
        return v.reshape(accum, v.shape[0] // accum, *v.shape[1:])[i]
    loc = v.to_local()
    if loc.shape[0] % accum:
        raise ValueError(f"{loc.shape[0]} rows on this rank do not split "
                         f"into {accum} microbatches")
    loc = loc.reshape(accum, loc.shape[0] // accum, *loc.shape[1:])[i]
    return DTensor.from_local(loc, v.device_mesh, v.placements,
                              run_check=False)


def _require_trainable(params):
    if not all(p.requires_grad for p in params.parameters()):
        raise ValueError("the train state's parameters are frozen; build "
                         "it with init_train_state or requires_grad_()")


def _mean_over(group, tensors) -> None:
    """Average ``tensors`` in place across the group's ranks."""
    n = dp_world(group)
    if n > 1:
        for t in tensors:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
            t.div_(n)


def make_train_step(cfg, opt_cfg: opt_mod.OptConfig, *, use_scan=True,
                    remat=True, accum: int = 1, group=None) -> Callable:
    """(state, batch) -> (state, metrics) with ``loss``, ``grad_norm``
    and ``lr``.  ``batch`` holds this rank's rows, on the parameters'
    device; ``use_scan`` is passed on as the reference passes it.

    Every object alive when the step is made (modules, parameters,
    optimizer state: they live as long as the training does) leaves the
    cyclic collector's reach (``gc.freeze``): the objects a step's
    autograd makes set off a full collection every few steps, and it then
    walks only what the steps made, not the whole heap, whose walk
    stalled the card for 0.1-0.27 s a time."""
    gc.collect()
    gc.freeze()
    model = registry.get_model(cfg)

    def loss_of(params, batch):
        kw = {"remat": remat}
        if cfg.family in ("dense", "moe", "encdec"):
            kw["use_scan"] = use_scan
        return model.loss_fn(params, batch, cfg, **kw)

    def grads_of(params, batch):
        if accum == 1:
            loss = loss_of(params, batch)
            loss.backward()
            return loss.detach(), _grads(params)
        l_sum = torch.zeros((), dtype=torch.float32, device=params.device)
        for i in range(accum):
            mb = {k: _microbatch(v, accum, i) for k, v in batch.items()}
            loss = loss_of(params, mb)
            loss.backward()                  # adds into each .grad
            l_sum = l_sum + loss.detach()
        return l_sum / accum, [g / accum for g in _grads(params)]

    def train_step(state, batch):
        params = state["params"]
        _require_trainable(params)
        sharded = is_sharded(params)
        params.zero_grad(set_to_none=True)
        # plain tensors inside the models (positions, masks, the
        # schedule's scalars) meet DTensors as replicated values
        with implicit_replication() if sharded else contextlib.nullcontext():
            loss, grads = grads_of(params, batch)
            if not sharded:
                _mean_over(group, grads + [loss])
            params, opt_state, om = opt_mod.adamw_update(
                grads, state["opt"], params, opt_cfg)
        if cfg.router == "sigmoid":
            _balance(params, cfg, None if sharded else group)
        params.zero_grad(set_to_none=True)
        new_state = {"params": params, "opt": opt_state,
                     "step": state["step"] + 1}
        return new_state, {"loss": _whole(loss),
                           **{k: _whole(v) for k, v in om.items()}}

    return train_step


def _balance(params, cfg, group) -> None:
    """Each sigmoid router's selection bias moved by the step's
    assignment counts (``moe.update_bias``), summed over the group's
    ranks first."""
    with trace.span("moe.bias"):
        for lp in params["layers"]:
            if "moe" in lp:
                if dp_world(group) > 1:
                    dist.all_reduce(lp["moe"]["counts"], group=group)
                moe.update_bias(lp["moe"], cfg.bias_rate)


def init_train_state(cfg, seed: int = 0, device=None) -> dict:
    """Trainable parameters drawn from a ``torch.Generator`` seeded
    ``seed`` on ``device`` (default the card), zero moments, step 0."""
    dev = resolve_device(device)
    params = registry.get_model(cfg).init(cfg, seed, dev)
    params.requires_grad_(True)
    return {"params": params, "opt": opt_mod.init_opt_state(params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def state_pspecs(specs) -> dict:
    """The spec tree of a train state whose parameters have ``specs``:
    the moments as the parameters, ``count`` and ``step`` None (every
    rank holds them whole)."""
    return {"params": specs, "opt": {"m": specs, "v": specs, "count": None},
            "step": None}


def shard_train_state(state: dict, mesh, specs) -> dict:
    """``state`` on ``mesh``: parameters and the AdamW moments as
    ``DTensor``s at the placements of ``specs`` (``registry.
    param_pspecs``), ``count`` and ``step`` as they are (every rank
    holds them).  After ``convert.train_state_from_numpy`` this carries
    the reference's train state onto a mesh."""
    opt = state["opt"]
    return {"params": registry.distribute_params(state["params"], mesh,
                                                 specs),
            "opt": {"m": registry.distribute_params(opt["m"], mesh, specs),
                    "v": registry.distribute_params(opt["v"], mesh, specs),
                    "count": opt["count"]},
            "step": state["step"]}


# ---------------------------------------------------------------------------
# Compressed-DP step over a process group: the paper's quantizer as
# gradient compression with error feedback
# ---------------------------------------------------------------------------

def make_dp_compressed_step(cfg, opt_cfg: opt_mod.OptConfig, group,
                            comp: secure_agg.CompressionConfig) -> Callable:
    """Pure data-parallel trainer whose gradient all-reduce is quantized.

    The state adds ``residuals`` (error feedback, a tree like the
    parameters).  Each rank passes its rows of the global batch and holds
    a full copy of the parameters; loss and gradients are averaged over
    the group's ranks."""
    model = registry.get_model(cfg)

    def step(state, batch):
        params = state["params"]
        _require_trainable(params)
        n_dev = float(dp_world(group))
        params.zero_grad(set_to_none=True)
        loss = model.loss_fn(params, batch, cfg, use_scan=False)
        loss.backward()
        grads, residuals = secure_agg.compress_tree_psum(
            _grads(params), group, comp,
            opt_mod.leaves(state["residuals"]))
        grads = [g / n_dev for g in grads]
        with torch.no_grad():
            for r, new in zip(opt_mod.leaves(state["residuals"]), residuals):
                r.copy_(new)
        params, opt_state, om = opt_mod.adamw_update(
            grads, state["opt"], params, opt_cfg)
        params.zero_grad(set_to_none=True)
        loss = loss.detach().reshape(1)
        dist.all_reduce(loss, op=dist.ReduceOp.SUM, group=group)
        return ({"params": params, "opt": opt_state,
                 "residuals": state["residuals"],
                 "step": state["step"] + 1},
                {"loss": loss[0] / n_dev, "grad_norm": om["grad_norm"]})

    return step


def init_dp_state(cfg, seed: int = 0, device=None) -> dict:
    state = init_train_state(cfg, seed, device)
    state["residuals"] = state["params"].map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device))
    return state
