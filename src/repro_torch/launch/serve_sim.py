"""Multi-tenant protocol serving simulation CLI.

Admits N tenant protocol instances (round-robin over the requested
workload families) into one :class:`repro_torch.serve.protocol_engine.
ProtocolEngine` on a shared virtual clock, runs them to completion with
cross-tenant launch coalescing, and prints a JSON summary (fusion
counters, per-tenant rounds and p50/p95 round latency, wall time).  Port
of ``repro.launch.serve_sim`` with the same flags plus ``--device``
(default ``cuda``: the big-integer work runs on the card; ``--device cpu``
runs the kernels' plain versions) and ``--tune-widths``.

Examples:
  python -m repro_torch.launch.serve_sim --tenants 8
  python -m repro_torch.launch.serve_sim --tenants 16 --workloads lasso,ridge \
      --cipher gold --admission concurrent
  python -m repro_torch.launch.serve_sim --tenants 8 --admission auto --tune
  python -m repro_torch.launch.serve_sim --tenants 4 --trace serve.trace.json
  python -m repro_torch.launch.serve_sim --tenants 4 --device cpu

``--admission auto`` reads the tuned admission window from the dispatch
calibration cache (``$REPRO_CALIB_CACHE``, default
``~/.cache/repro_torch/dispatch_calib.json``; falling back to sequential
when absent); ``--tune`` runs the
:func:`repro_torch.serve.protocol_engine.tune_admission` sweep first and
persists the knee for later auto runs on the same device kind.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch import workloads
from repro_torch.core import protocol
from repro_torch.core.quantization import QuantSpec
from repro_torch.data.synthetic import make_lasso
from repro_torch.obs import chrome_trace, trace as trace_mod
from repro_torch.runtime import dispatch
from repro_torch.serve.protocol_engine import ADMISSIONS, ProtocolEngine, \
    tune_admission


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tenants", type=int, default=8)
    ap.add_argument("--workloads", default="lasso", metavar="NAMES",
                    help="comma-separated workload families assigned "
                         "round-robin to tenants (repro_torch.workloads "
                         "names)")
    ap.add_argument("--cipher", default="gold",
                    choices=["plain", "gold", "vec"])
    ap.add_argument("--key-bits", type=int, default=128)
    ap.add_argument("--edges", type=int, default=2, help="K per tenant")
    ap.add_argument("--block", type=int, default=8,
                    help="coefficients per edge (N = edges * block)")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--admission", default="concurrent",
                    choices=sorted(ADMISSIONS))
    ap.add_argument("--stagger", type=float, default=0.0,
                    help="virtual seconds between tenant admit times")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--calib-cache", default=None,
                    help="override the dispatch calibration cache path")
    ap.add_argument("--tune", action="store_true",
                    help="run the admission-window sweep first and "
                         "persist the rounds/sec knee for --admission auto")
    ap.add_argument("--tune-widths", default="1,2,4,8,16", metavar="WIDTHS",
                    help="comma-separated concurrent tenant counts the "
                         "--tune sweep may try, in order")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write a chrome://tracing JSON with the serve "
                         "spans (admit/start/done + fused launches) and "
                         "the first tenant's RunReport embedded")
    ap.add_argument("--device", default="cuda",
                    help="where the big-integer work runs: cuda (the "
                         "card; raises without one) or cpu (the kernels' "
                         "plain versions)")
    return ap


def _tenant_case(name: str, M: int, N: int, K: int, iters: int, seed: int):
    """(workload_obj, A, y, spec) for one tenant's problem family."""
    if name == "lasso":
        inst = make_lasso(M, N, sparsity=0.1, noise=0.01, seed=seed)
        return None, inst.A, inst.y, QuantSpec(delta=1e6, zmin=-8.0,
                                               zmax=8.0)
    wl = workloads.get_default(name)
    n = N // K if wl.split == "rows" else N
    winst = wl.make_instance(M, n, K, seed=seed)
    spec = wl.calibrate_spec(winst.A, winst.y, K, iters)
    return wl, winst.A, winst.y, spec


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    K = args.edges
    N = K * args.block
    M = max(N // 2, 8)
    fams = [w.strip() for w in args.workloads.split(",") if w.strip()]
    for w in fams:
        if w != "lasso" and w not in workloads.names():
            raise SystemExit(f"unknown workload {w!r}")

    cases = {w: _tenant_case(w, M, N, K, args.iters, seed=1) for w in fams}

    def cfg_for(name: str, seed: int) -> protocol.ProtocolConfig:
        _, _, _, spec = cases[name]
        return protocol.ProtocolConfig(
            K=K, lam=0.05, iters=args.iters, spec=spec, workload=name,
            cipher=args.cipher, key_bits=args.key_bits, seed=seed)

    if args.tune:
        wl0, A0, y0, _ = cases[fams[0]]
        widths = tuple(int(w) for w in args.tune_widths.split(",") if w)
        tuned = tune_admission(A0, y0, cfg_for(fams[0], 0), widths=widths,
                               workload=wl0, calib_path=args.calib_cache,
                               device=args.device)
        print(json.dumps({"tuned": tuned}, indent=1))

    tracer = trace_mod.Tracer() if args.trace else trace_mod.NULL
    eng = ProtocolEngine(seed=args.seed, admission=args.admission,
                         calib_path=args.calib_cache, trace=tracer)
    for i in range(args.tenants):
        name = fams[i % len(fams)]
        wl, A, y, _ = cases[name]
        eng.admit(A, y, cfg_for(name, seed=i), tid=f"t{i}",
                  admit_at=i * args.stagger, workload=wl, device=args.device)
    t0 = time.perf_counter()
    results = eng.run()
    if torch.device(args.device).type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    serve = eng.stats()["serve"]
    total_rounds = sum(p["rounds"] for p in serve["per_tenant"].values())
    summary = {
        "tenants": args.tenants,
        "workloads": fams,
        "cipher": args.cipher,
        "key_bits": args.key_bits,
        "admission": serve["admission"],
        "window": serve["window"],
        "auto_fallback_sequential": serve["auto_fallback_sequential"],
        "wall_s": wall,
        "virtual_time_s": serve["virtual_time"],
        "agg_rounds_per_sec": total_rounds / max(wall, 1e-9),
        "launches": serve["launches"],
        "rows_launches": serve["rows_launches"],
        "fused_launches": serve["fused_launches"],
        "fused_ops": serve["fused_ops"],
        "per_tenant": {tid: {k: p[k] for k in
                             ("rounds", "cancelled", "launches",
                              "round_latency_s")}
                       for tid, p in serve["per_tenant"].items()},
        "device": dispatch.device_kind(args.device),
    }
    if args.trace:
        first = results[next(iter(results))]
        chrome_trace.write(args.trace, tracer, run_report=first.stats)
        summary["trace"] = {"path": args.trace, "spans": len(tracer.spans)}
    print(json.dumps(summary, indent=1))
    return summary


if __name__ == "__main__":
    main()
