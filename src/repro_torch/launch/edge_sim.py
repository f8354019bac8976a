"""Edge-network protocol simulation CLI.

Runs 3P-ADMM-PC2 on the event-driven runtime over a chosen topology,
node count, link model, and cipher backend, and prints a JSON summary
(solution quality, simulated wall-clock, per-direction traffic,
coalescing/dispatch telemetry).  Port of ``repro.launch.edge_sim`` with
the same flags plus ``--device`` (default ``cuda``: the big-integer work
runs on the card; ``--device cpu`` runs the kernels' plain versions).

Examples:
  python -m repro_torch.launch.edge_sim --topology star --edges 8 --backend auto
  python -m repro_torch.launch.edge_sim --workload logistic --edges 4 --backend gold
  python -m repro_torch.launch.edge_sim --topology ring --edges 16 --backend plain \
      --mode deadline --deadline 0.5 --slow-edge 3
  python -m repro_torch.launch.edge_sim --topology hierarchical --edges 32 \
      --backend plain --jitter 2e-3 --drop 0.01 --device cpu

``--backend auto`` calibrates the gold/vec throughput grid on the device
on first use and caches it (``$REPRO_CALIB_CACHE``, default
``~/.cache/repro_torch/dispatch_calib.json``); later runs start instantly.
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from repro_torch import workloads
from repro_torch.core import protocol
from repro_torch.core.churn import ChurnSchedule
from repro_torch.core.quantization import QuantSpec
from repro_torch.data.synthetic import make_lasso
from repro_torch.obs import chrome_trace, trace as trace_mod
from repro_torch.runtime import LinkModel, dispatch, topology as topo_mod
from repro_torch.runtime.runner import run_on_runtime


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--topology", default="star",
                    choices=sorted(topo_mod.KINDS))
    ap.add_argument("--edges", type=int, default=8, help="K edge nodes")
    ap.add_argument("--backend", default="plain",
                    choices=["plain", "gold", "vec", "auto"])
    ap.add_argument("--workload", default=None, choices=workloads.names(),
                    help="ADMM problem family (repro_torch.workloads "
                         "registry); "
                         "quantization range is auto-calibrated from the "
                         "data. Default: the legacy LASSO setup with the "
                         "fixed [-8, 8] range")
    ap.add_argument("--iters", type=int, default=12)
    ap.add_argument("--key-bits", type=int, default=128)
    ap.add_argument("--block", type=int, default=6,
                    help="coefficients per edge (N = edges * block)")
    ap.add_argument("--mode", default=None, choices=["sync", "deadline"])
    ap.add_argument("--deadline", type=float, default=None,
                    help="per-iteration straggler cutoff (virtual s)")
    ap.add_argument("--slow-edge", type=int, default=None,
                    help="make this edge a 10x straggler")
    ap.add_argument("--latency", type=float, default=1e-3)
    ap.add_argument("--bandwidth", type=float, default=125e6)
    ap.add_argument("--jitter", type=float, default=0.0)
    ap.add_argument("--drop", type=float, default=0.0)
    ap.add_argument("--churn", default=None, metavar="SPEC",
                    help="membership churn schedule: 'quarter' (25%% of "
                         "the edges leave at iters/3 and rejoin at "
                         "2*iters/3), 'quarter:fail' (same but silent "
                         "crashes — needs --mode deadline), or "
                         "'random[:rate[:fail_frac]]' (seeded per-round "
                         "churn, e.g. random:0.1:0.5)")
    ap.add_argument("--recycle", action="store_true",
                    help="recycled updates: an edge whose quantized "
                         "inputs did not move since its last encrypted "
                         "round reuses the cached decrypted chain, "
                         "skipping enc + launch + dec (exact at the "
                         "default tolerance 0)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--calib-cache", default=None,
                    help="override the dispatch calibration cache path")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write a chrome://tracing / Perfetto JSON trace "
                         "(phase/launch/message/dispatch spans) plus the "
                         "embedded RunReport")
    ap.add_argument("--health", action="store_true",
                    help="live protocol-health monitoring "
                         "(repro_torch.obs.health): MSE divergence/stall, "
                         "quantizer saturation, stale/death storms, "
                         "coalesce queue blowup; alerts appear in the "
                         "summary and, with --trace, as 'alert' spans")
    ap.add_argument("--device", default="cuda",
                    help="where the big-integer work runs: cuda (the "
                         "card; raises without one) or cpu (the kernels' "
                         "plain versions)")
    return ap


def parse_churn(spec: str, K: int, iters: int, seed: int) -> ChurnSchedule:
    """``--churn`` spec string -> a validated :class:`ChurnSchedule`."""
    head, *rest = spec.split(":")
    if head == "quarter":
        kind = rest[0] if rest else "leave"
        return ChurnSchedule.quarter(K, iters, kind=kind)
    if head == "random":
        rate = float(rest[0]) if rest else 0.1
        fail_frac = float(rest[1]) if len(rest) > 1 else 0.0
        return ChurnSchedule.random(K, iters, seed=seed, rate=rate,
                                    fail_frac=fail_frac)
    raise SystemExit(f"unknown --churn spec {spec!r} "
                     "(expected quarter[:kind] or random[:rate[:fail_frac]])")


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    K = args.edges
    N = K * args.block
    M = max(N // 2, 8)
    churn = (parse_churn(args.churn, K, args.iters, args.seed)
             if args.churn else None)
    wl = None
    if args.workload is not None:
        wl = workloads.get(args.workload, rho=1.0, lam=0.05)
        winst = wl.make_instance(M, N, K, seed=args.seed)
        inst_A, inst_y, x_true = winst.A, winst.y, winst.x_true
        # the quantization-range contract must cover the churned
        # trajectory, not the full-membership one (the rehearsal treats
        # fails as graceful departures: the range only depends on which
        # blocks participate)
        spec = wl.calibrate_spec(inst_A, inst_y, K, args.iters,
                                 churn=churn)
    else:   # legacy LASSO setup, fixed quantization range
        inst = make_lasso(M, N, sparsity=0.1, noise=0.01, seed=args.seed)
        inst_A, inst_y, x_true = inst.A, inst.y, inst.x_true
        spec = QuantSpec(delta=1e6, zmin=-8.0, zmax=8.0)

    latency_fn = None
    if args.slow_edge is not None:
        base, slow = 0.05, 0.5
        latency_fn = (lambda k, t:
                      slow if k == args.slow_edge % K else base)
    cfg = protocol.ProtocolConfig(
        K=K, lam=0.05, iters=args.iters, spec=spec,
        workload=args.workload or "lasso",
        cipher=args.backend, key_bits=args.key_bits, seed=args.seed,
        deadline=args.deadline, latency_fn=latency_fn,
        churn=churn, recycle=args.recycle)
    link = LinkModel(bytes_per_s=args.bandwidth, latency_s=args.latency,
                     jitter_s=args.jitter, drop_prob=args.drop)
    tracer = trace_mod.Tracer() if args.trace else trace_mod.NULL
    r = run_on_runtime(
        inst_A, inst_y, cfg, workload=wl,
        topology=topo_mod.make(args.topology, K),
        link=link, mode=args.mode, calib_path=args.calib_cache,
        trace=tracer, health=args.health, device=args.device)

    rstats = r.stats["runtime"]
    # row-split consensus stacks K full-width copies: fold to one model
    # estimate before scoring against the N-dimensional truth
    x_model = wl.fold_solution(r.x, K) if wl is not None else r.x
    summary = {
        "topology": args.topology, "edges": K, "backend": args.backend,
        "workload": args.workload or "lasso",
        "iters": args.iters,
        "mse_vs_truth": (float(np.mean((x_model - x_true) ** 2))
                         if x_true is not None else None),
        "virtual_time_s": rstats["virtual_time"],
        "events": rstats["events"],
        "traffic_bytes": r.stats["traffic_bytes"],
        "reshare_events": r.stats.get("reshare_events", 0),
        "churn": r.stats["churn"],
        "stale_events": r.stale_events,
        "retransmits": rstats["retransmits"],
        "coalesced_ops": rstats["coalesced_ops"],
        "kernel_launches": rstats["launches"],
        "device": dispatch.device_kind(args.device),
    }
    if wl is not None:
        summary["workload_metrics"] = wl.metrics(winst, r.x)
    if "dispatch" in rstats:
        summary["dispatch_choices"] = rstats["dispatch"]
    if args.health:
        summary["health"] = rstats["health"]
    if args.trace:
        chrome_trace.write(args.trace, tracer, run_report=r.stats)
        summary["trace"] = {"path": args.trace, "spans": len(tracer.spans)}
    print(json.dumps(summary, indent=1))
    return summary


if __name__ == "__main__":
    main()
