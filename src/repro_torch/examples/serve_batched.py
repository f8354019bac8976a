"""Serve small models with batched requests through the Engine.

Port of ``examples/serve_batched.py``: the inference substrate the
decode_32k / long_500k dry-run cells lower (prefill, then the KV cache or
recurrent state, then batched greedy decode), for the reduced
``recurrentgemma_2b`` and ``yi_9b``.  Parameters come from a
``torch.Generator`` seeded 0 on the device; prompts from numpy's
generator seeded 0, as in the reference.

Run:  python -m repro_torch.examples.serve_batched [--device cpu]
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.configs import get_reduced
from repro_torch.examples import parse_args
from repro_torch.models import registry
from repro_torch.serve.engine import Engine

ARCHS = ("recurrentgemma_2b", "yi_9b")
BATCH, PROMPT, MAX_NEW = 4, 12, 16


def prompts(cfg) -> np.ndarray:
    rng = np.random.default_rng(0)
    return rng.integers(0, cfg.vocab, (BATCH, PROMPT), dtype=np.int32)


def serve(arch: str, device, cfg=None, params=None) -> tuple:
    """(tokens, seconds) of one batched greedy generation of ``arch``;
    ``cfg`` and ``params`` replace the reduced config and the seeded
    weights."""
    cfg = cfg or get_reduced(arch)
    if params is None:
        params = registry.get_model(cfg).init(cfg, 0, device)
    engine = Engine(cfg, params)
    t0 = time.time()
    out = engine.generate(prompts(cfg), max_new=MAX_NEW)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return out, time.time() - t0


def main(argv=None) -> dict:
    args = parse_args(__doc__, argv)
    outs = {}
    for arch in ARCHS:
        out, dt = serve(arch, args.device)
        print(f"{arch:22s} generated {out.shape[0]}x{out.shape[1]} tokens "
              f"in {dt:.2f}s ({out.shape[0]*out.shape[1]/dt:.1f} tok/s) "
              f"sample={out[0][:6].tolist()}")
        outs[arch] = out
    print("OK")
    return outs


if __name__ == "__main__":
    main()
