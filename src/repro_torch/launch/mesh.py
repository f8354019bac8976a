"""Process groups for data-parallel training.

Port of what ``repro.launch.train`` needs from ``repro.launch.mesh``: the
reference's ``data`` mesh axis becomes a ``torch.distributed`` process
group, one rank per device.  Gloo on the CPU, NCCL on cards; the store
is a TCP store on localhost, whose address every rank is given (nothing
on the machine announces a cluster).  A model axis (tensor parallelism
over ``registry.param_pspecs``) is not ported.
"""
from __future__ import annotations

import contextlib
import socket

import torch
import torch.distributed as dist

from .. import resolve_device


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_device(device, rank: int = 0) -> torch.device:
    """Rank ``rank``'s device: its own card, or the CPU."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    n = torch.cuda.device_count()
    if rank >= n:
        raise RuntimeError(f"rank {rank} needs card {rank}, but "
                           f"{n} card(s) are present")
    return torch.device("cuda", rank)


@contextlib.contextmanager
def process_group(device=None, world: int = 1, rank: int = 0,
                  port: int | None = None):
    """Join (or, for one rank, form) the default process group over
    ``tcp://127.0.0.1:<port>`` for the ``with`` block, NCCL for a card
    and gloo for the CPU; yields the group and tears it down after.  A
    card's rank binds its own card first."""
    if world > 1 and port is None:
        raise ValueError("every rank of a group of more than one needs "
                         "the same port")
    dev = rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=f"tcp://127.0.0.1:{port or free_port()}",
        world_size=world, rank=rank)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def dp_world(group=None) -> int:
    """Ranks in the data-parallel group (1 without one)."""
    return dist.get_world_size(group) if dist.is_initialized() else 1


def dp_rank(group=None) -> int:
    return dist.get_rank(group) if dist.is_initialized() else 0
