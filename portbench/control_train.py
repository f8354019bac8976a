"""The readings that set a train cell's limits, on the card at the cell's
own size: the program's sound runs, the control and the planted faults,
each judged by the cell's own comparison against the float32 reference.

    python3 portbench/control_train.py --cell yi9b_d8.train \\
        --seeds 11 12 13 ... --control 3

For every seed: the program's set-up (its warm-up steps, as a run makes
them) and its numbers against the reference's (``sound``).  For the first
``--control`` seeds also: the control, the plain reference put in the
program's place with every matrix product's operands rounded to float8
(the reference's ``fp8_mm``), one precision below the configuration's
bfloat16; and the program with each fault of :data:`FAULTS` planted.  One
JSON line each: seed, variant, ``correct`` and the numbers compared.  The
benchmark's own runs never run it.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _half_batch(transformer):
    """The loss over the first half of the batch's rows alone."""
    real = transformer.loss_fn

    def loss_fn(params, batch, cfg, **kw):
        half = {k: v[:v.shape[0] // 2] for k, v in batch.items()}
        return real(params, half, cfg, **kw)
    return transformer, "loss_fn", loss_fn


def _answer_altered(layers):
    """The loss's value 0.1 % off where it is produced (its gradient
    as it was)."""
    real = layers.nll

    def nll(logits, labels):
        out = real(logits, labels)
        return out + 1e-3 * out.detach()
    return layers, "nll", nll


def _unchanged(optimizer):
    """An optimizer step that returns the parameters and moments as they
    were."""
    def adamw_update(grads, opt_state, params, cfg):
        return params, opt_state, {"grad_norm": optimizer.global_norm(grads),
                                   "lr": optimizer.schedule(0, cfg)}
    return optimizer, "adamw_update", adamw_update


#: fault name -> (module, maker): the maker returns (owner, name, fake)
FAULTS = {
    "state_unchanged": ("repro_torch.train.optimizer", _unchanged),
    "half_batch": ("repro_torch.models.transformer", _half_batch),
    "answer_altered": ("repro_torch.models.layers", _answer_altered),
}


@contextlib.contextmanager
def planted(fault: str | None):
    if fault is None:
        yield
        return
    import importlib
    module, maker = FAULTS[fault]
    owner, name, fake = maker(importlib.import_module(module))
    real = getattr(owner, name)
    setattr(owner, name, fake)
    try:
        yield
    finally:
        setattr(owner, name, real)


def program_payload(cell, seed: int, device: str, fault=None) -> dict:
    """The program's warm-up numbers for one seed, as a run reads them
    before its window (none of the window's steps)."""
    import torch
    with planted(fault):
        driver = cell.driver.Driver(cell.config, cell.traffic["params"],
                                    seed, device)
        driver.setup()
    payload = dict(driver.warm, seed=seed, device=device, steps=0,
                   window_losses=[])
    del driver
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return payload


def readings(cell, seeds, control: int, device: str):
    """Yield one record a seed and variant."""
    train = cell.driver
    lm = train.reference(cell.config)
    limits = {k: v["limit"] for k, v in cell.config["limits"].items()}
    for i, seed in enumerate(seeds):
        variants = {"sound": program_payload(cell, seed, device)}
        if i < control:
            for fault in FAULTS:
                variants[fault] = program_payload(cell, seed, device, fault)
        ref = train.reference_readings(cell.config, variants["sound"])
        if i < control:
            fp8 = train.reference_readings(cell.config, variants["sound"],
                                           mm=lm.fp8_mm)
            variants["control_fp8"] = dict(variants["sound"], **fp8)
        for name, payload in variants.items():
            verdict = train.compare(payload, ref, limits)
            yield {"cell": cell.name, "seed": seed, "variant": name,
                   "correct": verdict["correct"],
                   "checks": {k: v["value"]
                              for k, v in verdict["checks"].items()},
                   "losses": payload["losses"], "ref_losses": ref["losses"]}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--cell", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--control", type=int, default=3)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from portbench import bench
    cell = bench.resolve_cell(args.cell)
    for record in readings(cell, args.seeds, args.control, args.device):
        print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
