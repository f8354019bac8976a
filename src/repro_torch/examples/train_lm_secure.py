"""End to end: train a ~100M-parameter LM for a few hundred steps
with the paper's quantizer as compressed gradient aggregation.

Port of ``examples/train_lm_secure.py``.  Two modes:
  --full   : xlstm-125m at its real config (125M parameters), 300 steps
             at 8 x 256;
  default  : the same pipeline at smoke scale (the reduced config, 60
             steps at 4 x 32), runnable everywhere; loss must drop >20%.

One rank (one card, or the CPU) takes the plain train step, as the
reference does on one device.  ``--ranks N`` (default: one per card)
trains data parallel over N ranks, one process each, started by the
launcher of ``launch.train --mesh``: every rank takes its rows of the
batch and the gradients cross as the Γ-quantized all-reduce with error
feedback (``train.loop.make_dp_compressed_step``, gloo on the CPU,
NCCL on cards).  The data pipeline, AdamW with its cosine schedule and
asynchronous checkpoints are live in both.  Parameters come from a
``torch.Generator`` seeded 0.

Run:  python -m repro_torch.examples.train_lm_secure [--full] [--device cpu]
"""
from __future__ import annotations

import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_reduced
from repro_torch.core.secure_agg import CompressionConfig
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.examples import parse_args
from repro_torch.launch import mesh
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import loop as loop_mod
from repro_torch.train.optimizer import OptConfig

CKPT_DIR = os.path.join(tempfile.gettempdir(), "repro_torch_secure_lm")


def _add(ap):
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--ranks", type=int, default=None,
                    help="data-parallel ranks (default: one per card; "
                         "1 on the CPU)")


def setup(args) -> tuple:
    """(config, steps, batch, seq) of the mode ``args`` selects."""
    cfg = get_config("xlstm_125m") if args.full \
        else get_reduced("xlstm_125m")
    steps = args.steps or (300 if args.full else 60)
    batch, seq = (8, 256) if args.full else (4, 32)
    return cfg, steps, batch, seq


def train(cfg, steps: int, batch: int, seq: int, device, *, rank=0,
          world=1, group=None, state=None) -> dict:
    """The training loop on one rank; returns the losses, the state and
    the compression config.  ``state`` replaces the seeded one (a
    one-rank state)."""
    comp = CompressionConfig(bits=8, enabled=world > 1, error_feedback=True)
    opt = OptConfig(lr=3e-3, warmup_steps=steps // 10, total_steps=steps)
    if world > 1:
        step_fn = loop_mod.make_dp_compressed_step(cfg, opt, group, comp)
        state = loop_mod.init_dp_state(cfg, 0, device)
    else:
        step_fn = loop_mod.make_train_step(cfg, opt, use_scan=False,
                                           remat=False)
        if state is None:
            state = loop_mod.init_train_state(cfg, 0, device)
    pipe = TokenPipeline(vocab=cfg.vocab, batch=batch, seq=seq, seed=0)
    lead = rank == 0
    losses, writers = [], []
    t0 = time.time()
    for i in range(steps):
        b = pipe.next(device=device, rank=rank, world=world)
        state, metrics = step_fn(state, b)
        losses.append(float(metrics["loss"]))
        if lead and (i + 1) % max(steps // 10, 1) == 0:
            print(f"step {i+1:4d}  loss={losses[-1]:.4f}  "
                  f"({(time.time()-t0)/(i+1):.2f}s/step)", flush=True)
        if lead and (i + 1) % max(steps // 3, 1) == 0:
            writers.append(ckpt.save_async(CKPT_DIR, i + 1, state,
                                           extra={"pipeline": pipe.state()}))
    for w in writers:
        w.join()
    return {"losses": losses, "state": state, "comp": comp}


def report(run: dict) -> None:
    """The reference's closing lines and its assert."""
    losses = run["losses"]
    first = np.mean(losses[:5])
    last = np.mean(losses[-5:])
    n = sum(p.numel() for p in run["state"]["params"].parameters())
    print(f"loss {first:.4f} -> {last:.4f} "
          f"({100 * (first - last) / first:.1f}% drop, "
          f"{n / 1e6:.1f}M params, compressed_allreduce="
          f"{'on' if run['comp'].enabled else 'off'})")
    assert last < first * 0.8, "loss must drop >20%"
    print("OK")


def _rank_main(rank, args, world, port):
    cfg, steps, batch, seq = setup(args)
    device = mesh.rank_device(args.device, rank)
    with mesh.process_group(device, world, rank, port) as group:
        run = train(cfg, steps, batch, seq, device, rank=rank, world=world,
                    group=group)
        if rank == 0:
            report(run)


def main(argv=None) -> dict | None:
    args = parse_args(__doc__, argv, _add)
    world = args.ranks or (torch.cuda.device_count()
                           if args.device.startswith("cuda") else 1)
    if world > 1:
        if args.device.startswith("cuda") \
                and torch.cuda.device_count() < world:
            raise SystemExit(f"train_lm_secure: --ranks {world} needs "
                             f"{world} cards, {torch.cuda.device_count()} "
                             f"present")
        mesh.launch_ranks(_rank_main, world, (args, world))
        return None
    cfg, steps, batch, seq = setup(args)
    run = train(cfg, steps, batch, seq, args.device)
    report(run)
    return run


if __name__ == "__main__":
    main()
