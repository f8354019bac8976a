"""Training entry point: ``python -m repro_torch.launch.train --arch <id> [...]``.

Port of ``repro.launch.train``: the data pipeline, AdamW, remat, atomic
checkpoints with resume, on the card (``--device cpu`` runs the same on
the CPU; without a card the default raises).  ``--mesh N`` trains data
parallel over a process group of N ranks, one per device (gloo on the
CPU, NCCL on cards), each on its rows of the global batch; ``--mesh 1``
is one device.  ``--mesh D,M`` trains on a D x M ``("data", "model")``
device mesh of D * M ranks: parameters and moments are ``DTensor``s at
``registry.param_pspecs``'s placements (FSDP on ``data``, tensor and
expert parallelism on ``model``), each data coordinate takes its rows of
the batch, and checkpoints are saved whole and restored onto the mesh.
Parameters come from a ``torch.Generator`` seeded 0.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, get_reduced
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch import mesh
from repro_torch.models import registry
from repro_torch.train import checkpoint as ckpt_mod
from repro_torch.train import fault
from repro_torch.train import loop as loop_mod
from repro_torch.train.optimizer import OptConfig


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--mesh", default="1",
                    help="mesh spec 'data[,model]', e.g. '4' (data "
                         "parallel) or '2,2' (a data x model mesh)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; never falls back")
    return ap


def mesh_dims(spec: str) -> tuple:
    """``--mesh``: ``(data,)`` or ``(data, model)``."""
    dims = tuple(int(x) for x in spec.split(","))
    if len(dims) > 2 or min(dims) < 1:
        raise ValueError(f"--mesh {spec!r}: expected 'data' or 'data,model'")
    return dims


def train(args, device, rank: int = 0, world: int = 1, group=None,
          dmesh=None):
    """The training loop on one rank (on ``dmesh``, a ``DeviceMesh``,
    when given); returns the last step's metrics."""
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    lead = rank == 0
    opt_cfg = OptConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                        total_steps=args.steps)
    train_step = loop_mod.make_train_step(cfg, opt_cfg, use_scan=True,
                                          remat=True, group=group)
    state = loop_mod.init_train_state(cfg, 0, device)
    shardings = None
    if dmesh is not None:
        specs = registry.param_pspecs(cfg, state["params"],
                                      mesh.mesh_shape_dict(dmesh))
        state = loop_mod.shard_train_state(state, dmesh, specs)
        shardings = fault.shardings_for(dmesh,
                                        loop_mod.state_pspecs(specs))
    pipe = TokenPipeline(
        vocab=cfg.vocab, batch=args.batch, seq=args.seq,
        prefix=cfg.n_prefix if cfg.frontend == "vision" else 0,
        enc_len=registry.enc_len(cfg, args.seq) if cfg.family == "encdec"
        else 0,
        d_model=cfg.d_model)

    start = 0
    if args.resume and args.ckpt_dir:
        last = ckpt_mod.latest_step(args.ckpt_dir)
        if last is not None:
            state, manifest = ckpt_mod.restore(args.ckpt_dir, state,
                                               device=device,
                                               shardings=shardings)
            pipe.load_state(manifest["extra"]["pipeline"])
            start = manifest["step"]
            if lead:
                print(f"resumed from step {start}", flush=True)

    metrics, saved = None, None
    t0 = time.time()
    # a mesh's ranks all join a checkpoint's gather; rank 0 writes
    saver = lead or dmesh is not None
    for i in range(start, args.steps):
        batch = (pipe.next(device=device, mesh=dmesh) if dmesh is not None
                 else pipe.next(device=device, rank=rank, world=world))
        state, metrics = train_step(state, batch)
        if lead and ((i + 1) % args.log_every == 0 or i == start):
            print(f"step {i+1:5d} loss={float(metrics['loss']):.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"lr={float(metrics['lr']):.2e} "
                  f"({(time.time()-t0)/(i-start+1):.2f}s/step)", flush=True)
        if saver and args.ckpt_dir and args.ckpt_every \
                and (i + 1) % args.ckpt_every == 0:
            ckpt_mod.save(args.ckpt_dir, i + 1, state,
                          extra={"pipeline": pipe.state()})
            saved = i + 1
    if saver and args.ckpt_dir and saved != args.steps:
        ckpt_mod.save(args.ckpt_dir, args.steps, state,
                      extra={"pipeline": pipe.state()})
    final = float(metrics["loss"]) if metrics else float("nan")
    if lead:
        print(f"done: {args.steps} steps, final loss {final:.4f}",
              flush=True)
    return metrics


def _rank_main(rank, args, dims, port):
    world = dims[0] if len(dims) == 1 else dims[0] * dims[1]
    device = mesh.rank_device(args.device, rank)
    with mesh.process_group(device, world, rank, port) as group:
        if len(dims) == 1:
            train(args, device, rank, world, group)
        else:
            dmesh = mesh.make_mesh(dims, ("data", "model"), device)
            train(args, device, rank, dmesh=dmesh)


def main(argv=None):
    args = build_parser().parse_args(argv)
    try:
        device = resolve_device(args.device)
        dims = mesh_dims(args.mesh)
    except (RuntimeError, ValueError) as e:
        raise SystemExit(f"train: {e}") from None
    world = dims[0] if len(dims) == 1 else dims[0] * dims[1]
    if len(dims) == 1 and world == 1:
        return train(args, device)
    if device.type == "cuda" and torch.cuda.device_count() < world:
        raise SystemExit(f"train: --mesh {world} needs {world} cards, "
                         f"{torch.cuda.device_count()} present")
    mesh.launch_ranks(_rank_main, world, (args, dims))


if __name__ == "__main__":
    main()
