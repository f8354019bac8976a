"""Process groups and device meshes.

Port of ``repro.launch.mesh``.  A process group holds one rank per
device: gloo on the CPU, NCCL on cards, over a TCP store on localhost
whose address every rank is given (nothing on the machine announces a
cluster).  ``make_mesh`` lays a ``DeviceMesh`` with named axes over the
default group (``("data", "model")``: FSDP and batch on ``data``, tensor
and expert parallelism on ``model``), the reference's ``jax.make_mesh``;
:func:`fake_group` forms a group of any size in one process, whose
collectives move nothing, for the dry-run (``launch.dryrun``), as the
reference's 512 placeholder devices do.  :func:`kernel_mesh` lists the
cards the crypto kernels' batches split over
(``core.paillier_batch._shard_batch``).

A group of more than one rank meets at a TCP store that the process
launching the ranks serves (:func:`serve_store`, as ``torchrun``'s agent
does): its port stays bound from before the first rank starts until
after the last has exited, so no other group can take it and no rank's
exit takes the store from a peer still tearing down.
"""
from __future__ import annotations

import contextlib
import datetime

import torch
import torch.distributed as dist

from .. import resolve_device

HOST = "127.0.0.1"
STORE_TIMEOUT = datetime.timedelta(seconds=300)


@contextlib.contextmanager
def serve_store():
    """Serve a TCP store on localhost for the ``with`` block, on a port
    the system picks; yields the port, which the ranks pass to
    :func:`process_group`."""
    store = dist.TCPStore(HOST, 0, None, True, STORE_TIMEOUT,
                          wait_for_workers=False)
    try:
        yield store.port
    finally:
        del store


def launch_ranks(fn, world: int, args: tuple = ()) -> None:
    """Run ``fn(rank, *args, port)`` in ``world`` spawned processes, one
    per rank, around a store this process serves; returns when every
    rank has exited (raises if one failed)."""
    import torch.multiprocessing as mp
    with serve_store() as port:
        mp.start_processes(fn, args=(*args, port), nprocs=world,
                           start_method="spawn")


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
    """Join the default process group for the ``with`` block, NCCL for a
    card and gloo for the CPU; yields the group and tears it down after.

    The ranks of a group of more than one meet at the store that
    :func:`serve_store` serves on ``port``; one rank serves its own.  A
    card's rank binds its own card first.  Every rank waits at a barrier
    before the teardown, so none closes its connections while a peer is
    still in a collective."""
    if world > 1 and port is None:
        raise ValueError("the ranks of a group of more than one meet at "
                         "the port of a store from serve_store()")
    dev = rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    store = (dist.TCPStore(HOST, port, None, False, STORE_TIMEOUT)
             if world > 1 else
             dist.TCPStore(HOST, 0, None, True, STORE_TIMEOUT,
                           wait_for_workers=False))
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            store=store, world_size=world, rank=rank)
    try:
        yield dist.group.WORLD
        if world > 1:
            dist.barrier()
    finally:
        dist.destroy_process_group()


def kernel_mesh(device=None) -> list | None:
    """The cards the crypto kernels' element batches split over
    (``core.paillier_batch._shard_batch``): every local card when there
    are more than one, else ``None``, as on the CPU (the reference's
    ``kernel_mesh`` is ``None`` on one device)."""
    if torch.device("cuda" if device is None else device).type != "cuda":
        return None
    n = torch.cuda.device_count()
    if n <= 1:
        return None
    return [torch.device("cuda", i) for i in range(n)]


@contextlib.contextmanager
def fake_group(world: int):
    """The default group as rank 0 of ``world`` ranks in this process,
    on PyTorch's fake backend (collectives return at once and move
    nothing); torn down after the ``with`` block."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), world_size=world,
                            rank=0)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def make_mesh(shape, axes, device=None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the default
    group (whose size must be the product of ``shape``), on the cards
    unless ``device`` is the CPU."""
    from torch.distributed.device_mesh import init_device_mesh
    dev = torch.device("cuda" if device is None else device)
    return init_device_mesh(dev.type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """16x16 ranks; the multi-pod mesh adds a leading 2-pod axis.

    Axes: `data` carries FSDP + batch sharding, `model` carries TP/EP;
    `pod` (multi-pod) carries pure DP: parameters stay pod-replicated and
    gradients all-reduce across (pod, data).
    """
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def mesh_shape_dict(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def dp_axes(mesh) -> tuple:
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def dp_world(group=None) -> int:
    """Ranks in the data-parallel group (1 without one)."""
    return dist.get_world_size(group) if dist.is_initialized() else 1


def dp_rank(group=None) -> int:
    return dist.get_rank(group) if dist.is_initialized() else 0
