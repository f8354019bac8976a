"""Readings behind an afmoe train cell's limits that ``control_train``
does not make: the selection bias's own faults, and each number with the
routing held to the program's choices.

    python3 portbench/control_afmoe.py --cell trinity_mini_d8.train8k \\
        --seeds 11 12 13

For every seed, one JSON line a variant, each judged by the cell's own
comparison (``drivers/train.compare``):

* ``sound`` and ``control_fp8``, as ``control_train`` reads them;
* ``bias_frozen`` (``moe.update_bias`` clears the counts and moves no
  bias) and ``bias_flipped`` (the rule's sign turned), planted in the
  program;
* ``sound_fixed`` and ``control_fp8_fixed``: the same two against a
  reference that takes, in each step and layer, the experts the program
  chose (with its own weights over them), so that no near-tied choice
  flips between the two.

Each line names the worst leaves of ``grad_gap`` and ``change_gap`` and
gives the largest gap between the program's and the reference's
selection biases after the steps, and how many entries differ.  The
benchmark's own runs never run it.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _frozen(moe):
    def update_bias(p, rate):
        p["counts"].zero_()
    return moe, "update_bias", update_bias


def _flipped(moe):
    real = moe.update_bias

    def update_bias(p, rate):
        real(p, -rate)
    return moe, "update_bias", update_bias


#: fault name -> maker: the maker returns (owner, name, fake)
FAULTS = {"bias_frozen": _frozen, "bias_flipped": _flipped}


@contextlib.contextmanager
def patched(owner, name, fake):
    real = getattr(owner, name)
    setattr(owner, name, fake)
    try:
        yield
    finally:
        setattr(owner, name, real)


def program_payload(cell, seed: int, device: str, fault=None) -> dict:
    """``control_train.program_payload``, plus the experts the program
    chose in each counted layer call (``chosen``, in order) and each MoE
    layer's selection bias after the warm-up (``bias``)."""
    import torch
    from repro_torch.models import moe
    chosen, real = [], moe.route

    def route(p, x, cfg):
        top, w = real(p, x, cfg)
        if moe._counting():
            chosen.append(top.cpu())
        return top, w
    with contextlib.ExitStack() as stack:
        stack.enter_context(patched(moe, "route", route))
        if fault:
            stack.enter_context(patched(*FAULTS[fault](moe)))
        driver = cell.driver.Driver(cell.config, cell.traffic["params"],
                                    seed, device)
        driver.setup()
    bias = {int(n.split(".")[1]): b.cpu() for n, b in
            driver.state["params"].named_buffers() if n.endswith("moe.bias")}
    payload = dict(driver.warm, seed=seed, device=device, steps=0,
                   window_losses=[], chosen=chosen, bias=bias)
    del driver
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return payload


def reference_fixed(cell, payload: dict, mm=None) -> dict:
    """``drivers/train.reference_readings`` with the reference taking the
    program's chosen experts (``payload["chosen"]``) in each step and
    layer, and its own weights over them."""
    import torch
    lm = cell.driver.reference(cell.config)
    cfg = cell.config
    layers = [i for i in range(cfg["n_layers"]) if lm.is_moe(cfg, i)]
    step, routers = [-1], {}
    real_loss = lm.loss

    def loss(params, *args, **kw):
        step[0] += 1
        routers.clear()
        routers.update({id(params[f"layers.{i}.moe.router"]): n
                        for n, i in enumerate(layers)})
        return real_loss(params, *args, **kw)

    def route(x, p, cfg, mm, bias):
        n = routers[id(p["moe.router"])]
        top = payload["chosen"][step[0] * len(layers) + n].to(x.device)
        w = torch.gather(torch.sigmoid(mm(x, p["moe.router"])), 1, top)
        return top, cfg["route_scale"] * w / w.sum(dim=-1, keepdim=True)
    with patched(lm, "loss", loss), patched(lm, "route", route):
        return cell.driver.reference_readings(cfg, payload, mm=mm)


def worst(got: dict, want: dict, leaves, n: int = 3) -> list:
    """The ``n`` leaves with the largest gaps, as ``leaf_gap`` takes
    them."""
    floor = statistics.median(want.values())
    gaps = sorted(((abs(got[k] - want[k]) / max(want[k], floor), k)
                   for k in leaves), reverse=True)
    return [[k, g] for g, k in gaps[:n]]


def bias_gap(got: dict, want: dict) -> tuple[float, int]:
    """The largest gap between two runs' selection biases, and how many
    entries differ."""
    diffs = [(got[i].cpu() - want[i].cpu()).abs() for i in want]
    return (max(float(d.max()) for d in diffs),
            sum(int((d > 0).sum()) for d in diffs))


def readings(cell, seeds, device: str):
    """Yield one record a seed and variant."""
    train = cell.driver
    lm = train.reference(cell.config)
    limits = {k: v["limit"] for k, v in cell.config["limits"].items()}
    for seed in seeds:
        sound = program_payload(cell, seed, device)
        planted = {f: program_payload(cell, seed, device, f)
                   for f in FAULTS}
        refs = {"free": train.reference_readings(cell.config, sound),
                "fixed": reference_fixed(cell, sound)}
        rows = [("sound", sound, "free")]
        rows += [(f, p, "free") for f, p in planted.items()]
        rows += [("control_fp8", dict(sound, **train.reference_readings(
            cell.config, sound, mm=lm.fp8_mm)), "free"),
            ("sound_fixed", sound, "fixed"),
            ("control_fp8_fixed", dict(sound, **reference_fixed(
                cell, sound, mm=lm.fp8_mm)), "fixed")]
        for name, payload, against in rows:
            ref = refs[against]
            verdict = train.compare(payload, ref, limits)
            gmed = statistics.median(ref["grad_norms"].values())
            moved = [k for k, g in ref["grad_norms"].items()
                     if g >= 1e-3 * gmed]
            gap, differ = bias_gap(payload["bias"], ref["bias"])
            yield {"cell": cell.name, "seed": seed, "variant": name,
                   "correct": verdict["correct"],
                   "checks": {k: v["value"]
                              for k, v in verdict["checks"].items()},
                   "worst_grad": worst(payload["grad_norms"],
                                       ref["grad_norms"], ref["grad_norms"]),
                   "worst_change": worst(payload["change_norms"],
                                         ref["change_norms"], moved),
                   "bias_gap": gap, "bias_entries_differ": differ,
                   "losses": payload["losses"], "ref_losses": ref["losses"]}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--cell", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from portbench import bench
    cell = bench.resolve_cell(args.cell)
    for record in readings(cell, args.seeds, args.device):
        print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
