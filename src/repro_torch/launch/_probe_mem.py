"""Memory probe for a train cell on the fake 16 x 16 group (a dev tool).

Port of ``repro.launch._probe_mem``: one train step of ``--arch`` at
``--batch`` x ``--seq`` with the residual stream constrained as
``--constraint`` says (``seq``: sequence over ``model``; ``hidden``:
hidden over ``model``; ``none``) and ``--remat``, run once as rank 0 of
256 over ``meta`` tensors (``launch.mesh.fake_group``) under
``dryrun.StepMeter``.  It prints the reference's ``RESULT`` line with the
fields the meter measures: peak, temp and argument GB a card, the matmul
flops a card, and ``run`` (the step's seconds on the meter) in place of
the reference's compile time.  The reference's ``--shardy`` (XLA's
Shardy partitioner) and ``--scan`` (the scanned layer stack) have no
counterpart: DTensor propagates shardings op by op and the port's layers
run unrolled, so those flags exit with an error.

Usage:
  python -m repro_torch.launch._probe_mem --arch yi_9b --constraint hidden --remat [--device cpu]
"""
from __future__ import annotations

import argparse
import time

from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import layers as L

#: --constraint -> the dimension of the residual stream split over
#: ``model`` (``None``: no constraint)
CONSTRAINTS = {"none": None, "seq": 1, "hidden": 2}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="yi_9b")
    ap.add_argument("--constraint", default="none",
                    choices=list(CONSTRAINTS))
    ap.add_argument("--shardy", action="store_true",
                    help="XLA's Shardy partitioner: not in the port")
    ap.add_argument("--scan", action="store_true",
                    help="the scanned layer stack: not in the port")
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--device", default="cuda",
                    help="the mesh's device type (cuda or cpu)")
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    for flag in ("shardy", "scan"):
        if getattr(args, flag):
            raise SystemExit(
                f"_probe_mem: --{flag} selects "
                + ("XLA's Shardy partitioner" if flag == "shardy"
                   else "the reference's scanned layer stack")
                + "; the port has none (DTensor propagates shardings op "
                  "by op and the layers run unrolled)")
    cfg = get_config(args.arch)
    sh = dict(kind="train", seq=args.seq, batch=args.batch)
    with mesh_mod.fake_group(256):
        mesh = mesh_mod.make_mesh((16, 16), ("data", "model"), args.device)
        try:
            run, held = dryrun.build_train_cell(
                cfg, sh, mesh, remat=args.remat,
                act_dim=CONSTRAINTS[args.constraint])
            meter = dryrun.StepMeter()
            args_bytes = meter.track(held)
            t1 = time.time()
            with meter:
                run()
            t_run = time.time() - t1
            del run, held
        finally:
            L.set_activation_sharding(None)
    gb = 2 ** 30
    res = {"peak": meter.peak / gb, "temp": (meter.peak - args_bytes) / gb,
           "args": args_bytes / gb, "run": t_run,
           "flops": sum(meter.flops.values())}
    print(f"RESULT arch={args.arch} constraint={args.constraint} "
          f"shardy={args.shardy} scan={args.scan} remat={args.remat} "
          f"peak={res['peak']:.1f}GB temp={res['temp']:.1f}GB "
          f"args={res['args']:.1f}GB run={res['run']:.0f}s "
          f"flops={res['flops']:.3e}", flush=True)
    return res


if __name__ == "__main__":
    main()
