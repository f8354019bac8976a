"""Learning rates for the full-width Yi-9B train step of ``chip_smoke.py``.

``python3 scripts/train_lr_sweep.py`` on a machine with an NVIDIA card
trains Yi-9B at full width with 8 of its 48 layers (T1 of
``chip_smoke.py``: batch 4 x 1,024 from ``TokenPipeline``, remat, bf16
matmuls on float32 master weights) for six ``make_train_step`` steps at
each of a few peak learning rates (warm-up of one step, cosine decay
over the six), from the same seeded weights, and prints each step's
loss, grad norm and milliseconds (device synchronized), then the peak
memory.  AdamW's first steps are sign steps: every element moves by
about lr whatever its gradient, so at this width a rate that suits a
long run with warm-up throws the loss up on the second step.  It checks
nothing; ``chip_smoke.py`` gates the rate it uses.
"""
import sys
import time
from dataclasses import replace
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import TokenPipeline  # noqa: E402
from repro_torch.train import loop, optimizer  # noqa: E402

LRS = (3e-4, 3e-5, 1e-5, 3e-6, 1e-6)
LAYERS, BATCH, SEQ, STEPS = 8, 4, 1024, 6


def main():
    dev = torch.device("cuda")
    cfg = replace(get_config("yi_9b"), n_layers=LAYERS)
    print(torch.cuda.get_device_name(0), flush=True)
    for lr in LRS:
        torch.cuda.reset_peak_memory_stats()
        state = loop.init_train_state(cfg, 0, dev)
        step = loop.make_train_step(cfg, optimizer.OptConfig(
            lr=lr, warmup_steps=1, total_steps=STEPS), remat=True)
        pipe = TokenPipeline(cfg.vocab, BATCH, SEQ)
        rows = []
        for _ in range(STEPS):
            batch = pipe.next(device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, met = step(state, batch)
            torch.cuda.synchronize()
            rows.append((round(float(met["loss"]), 4),
                         round(float(met["grad_norm"]), 3),
                         round((time.perf_counter() - t0) * 1e3, 1)))
        print(f"lr {lr:g}: (loss, grad norm, ms) {rows}; peak "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
        del state, step
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
