"""Layer spans around calls into the program, for traced runs.

Each target below is wrapped, while a traced window is armed, in a
``torch.profiler.record_function`` span named ``<module>.<attribute>``,
so the trace shows which layer the host was in while the device sat idle.
The targets are looked up where their callers look them up (a module
attribute, or a name a module imported), and restored afterwards.
"""
from __future__ import annotations

import contextlib
import importlib

#: ``module:attribute`` of every call the traced run wraps, from the
#: drivers down to the kernel wrappers, and the train step's parts
TARGETS = (
    # drivers: the quantizer, Theorem 1, the master's update
    "repro_torch.core.protocol:gamma1",
    "repro_torch.core.protocol:gamma2",
    "repro_torch.core.protocol:dequantize_theorem1",
    "repro_torch.runtime.runner:gamma1",
    "repro_torch.runtime.runner:gamma2",
    "repro_torch.runtime.runner:dequantize_theorem1",
    "repro_torch.workloads.base:Workload.global_update",
    # coalescer
    "repro_torch.runtime.coalesce:CoalesceQueue.flush",
    "repro_torch.runtime.coalesce:CrossTenantCoalescer._execute",
    # Paillier batch
    "repro_torch.core.paillier_batch:enc_ct",
    "repro_torch.core.paillier_batch:add_ct",
    "repro_torch.core.paillier_batch:matvec_vec",
    "repro_torch.core.paillier_batch:matvec_many",
    "repro_torch.core.paillier_batch:dec_vec",
    "repro_torch.core.paillier_batch:enc_rows",
    "repro_torch.core.paillier_batch:add_rows",
    "repro_torch.core.paillier_batch:matvec_rows",
    "repro_torch.core.paillier_batch:dec_rows",
    "repro_torch.core.paillier_batch:modexp_crt_limbs",
    "repro_torch.core.paillier_batch:modexp_crt_limbs_in",
    "repro_torch.core.paillier_batch:_norm_exps",
    "repro_torch.core.paillier_vec:crt_combine_batch",
    "repro_torch.core.paillier_vec:_reduce_into",
    "repro_torch.core.bigint:to_ints",
    "repro_torch.core.bigint:from_ints",
    "repro_torch.core.bigint:to_device",
    # kernel wrappers
    "repro_torch.kernels.ops:mulmod",
    "repro_torch.kernels.ops:modexp",
    "repro_torch.kernels.ops:modexp_fixed_pair",
    "repro_torch.kernels.ops:mulmod_rows",
    "repro_torch.kernels.ops:modexp_rows",
    "repro_torch.kernels.ops:prod_rows",
    "repro_torch.kernels.ops:prod_mod",
    # model: the forward (each block, again where the backward recomputes
    # it), attention, the MLP and the loss; the backward; the optimizer
    "repro_torch.models.transformer:forward",
    "repro_torch.models.transformer:block",
    "repro_torch.models.layers:attention",
    "repro_torch.models.layers:mlp",
    "repro_torch.models.layers:nll",
    "torch:Tensor.backward",
    "repro_torch.train.optimizer:adamw_update",
)


def resolve(target: str):
    """``(owner, name, label)`` of one target."""
    module, attr = target.split(":")
    owner = importlib.import_module(module)
    *path, name = attr.split(".")
    for part in path:
        owner = getattr(owner, part)
    getattr(owner, name)                  # raises for a missing target
    return owner, name, label(target)


def label(target: str) -> str:
    """A target's span name: ``<module>.<attribute>``."""
    module, attr = target.split(":")
    return f"{module.rsplit('.', 1)[-1]}.{attr}"


def labels() -> set:
    """The span names the traced run uses."""
    return {label(t) for t in TARGETS}


def _wrap(real, label: str):
    import torch

    def wrapper(*args, **kwargs):
        with torch.profiler.record_function(label):
            return real(*args, **kwargs)
    return wrapper


@contextlib.contextmanager
def installed():
    undo = []
    try:
        for target in TARGETS:
            owner, name, label = resolve(target)
            real = owner.__dict__[name] if isinstance(owner, type) \
                else getattr(owner, name)
            setattr(owner, name, _wrap(real, label))
            undo.append((owner, name, real))
        yield
    finally:
        for owner, name, real in reversed(undo):
            setattr(owner, name, real)
