"""Serving driver: batched greedy decode through the Engine.

``python -m repro_torch.launch.serve --arch xlstm_125m --reduced --batch 4``
runs on the card; ``--device cpu`` runs the same on the CPU.  Parameters
are random, from a ``torch.Generator`` seeded 0; prompts (and the enc-dec
family's frames) from numpy's generator seeded 0, as in the reference's
driver.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, get_reduced
from repro_torch.models import registry
from repro_torch.serve.engine import Engine


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; never falls back")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        raise SystemExit(f"serve: {e}") from None
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    model = registry.get_model(cfg)
    params = model.init(cfg, 0, dev)
    engine = Engine(cfg, params)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, (args.batch, args.prompt_len),
                           dtype=np.int32)
    frames = None
    if cfg.family == "encdec":
        frames = rng.normal(0, 0.02, (args.batch, 8, cfg.d_model)
                            ).astype(np.float32)
    t0 = time.time()
    out = engine.generate(prompts, args.max_new, frames=frames)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dt = time.time() - t0
    tok_s = args.batch * args.max_new / dt
    print(f"generated {out.shape} in {dt:.2f}s ({tok_s:.1f} tok/s)")
    print("sample:", out[0][:16].tolist())
    return out


if __name__ == "__main__":
    main()
