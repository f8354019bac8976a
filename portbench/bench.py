"""The harness: run one cell of ``BENCHMARK.json`` once.

Everything is found by name.  A cell (an entry of ``workloads``) names a
configuration, whose file its ``configs`` entry gives, and a traffic mix,
``portbench/traffic/<traffic>.json``, which names a driver,
``portbench/drivers/<driver>.py``, and its parameters.  Each metric is
read by ``portbench/metrics/<metric>.py`` (see :func:`reader`).  So a configuration, a traffic
mix or a metric is added as new files and new entries, without an edit.

A run: the driver makes the inputs from the seed and warms the entry up
at the cell's shapes (set-up), then runs the window.  The device's peak
memory is read, the program's state freed, and the plain reference
works the outputs out again from the same inputs: the driver's own
``judge(outcome, config)`` where its module has one (a train step against
:mod:`portbench.reference.lm`), else :func:`portbench.reference.admm.judge`
(every tenant's iterates, bit for bit).
The result carries the cell's end-to-end metrics, or with ``trace`` its
per-layer metrics and the trace's breakdown.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
#: top-level modules the benchmark's process may never hold
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class NoCard(RuntimeError):
    """The cell needs more cards than this machine shows."""


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    driver: object              # the driver's module
    end_to_end: list            # the cell's entries of "end_to_end"
    per_layer: list             # the cell's entries of "per_layer"
    root: Path


@dataclasses.dataclass
class RunRecord:
    """What the metric readers read (``portbench/metrics/*.py``)."""
    tenants: int
    rounds: int                 # rounds each tenant ran in the window
    laps: list                  # every tenant-round's wall lap, s
    window_s: float
    setup_s: float
    launches: dict              # kernel body -> launches in the window
    shape_launches: dict        # (body, B, k) -> launches in the window
    serve: dict | None          # the cross-tenant coalescer's counters
    trace: object | None        # trace.TraceSummary of a traced run
    inputs: dict                # the judge's: nk, key_bits, code_bits
                                # (LASSO); model, seq (a train step)
    counts: dict = dataclasses.field(default_factory=dict)  # steps, tokens

    @property
    def tenant_rounds(self) -> int:
        return self.tenants * self.rounds


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _by_name(entries: list, name: str, what: str) -> dict:
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise ValueError(f"no {what} named {name!r}; BENCHMARK.json has "
                     f"{[e['name'] for e in entries]}")


def resolve_cell(name: str, root: Path = ROOT) -> Cell:
    bench = load_benchmark(root)
    cell = _by_name(bench["workloads"], name, "workload")
    config = _by_name(bench["configs"], cell["config"], "configuration")
    traffic = json.loads(
        (root / "portbench" / "traffic" / f"{cell['traffic']}.json")
        .read_text())
    driver = _load(root / "portbench" / "drivers" / f"{traffic['driver']}.py",
                   f"portbench.drivers.{traffic['driver']}")

    def applies(metric):
        return name in metric.get("workloads", (name,))
    return Cell(name=name, chips=cell["chips"],
                config=json.loads((root / config["file"]).read_text()),
                traffic=traffic, driver=driver,
                end_to_end=[m for m in bench["end_to_end"] if applies(m)],
                per_layer=[m for m in bench["per_layer"] if applies(m)],
                root=root)


def _load(path: Path, name: str):
    """The module at ``path``, under ``name`` (a metric's file name may
    hold dots, so files are loaded by path)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def reader(root: Path, metric: str):
    """The ``read(run)`` function of one metric: ``metrics/<metric>.py``,
    or, where there is none, the file of its name without the last
    ``.<part>`` (``idle_share.serve`` is read by ``idle_share.py``: one
    quantity split by the end-to-end metric it moves)."""
    folder = root / "portbench" / "metrics"
    name = metric
    if not (folder / f"{name}.py").exists() and "." in name:
        name = name.rsplit(".", 1)[0]
    return _load(folder / f"{name}.py", f"portbench.metrics.{name}").read


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _metrics(entries: list, run: RunRecord, root: Path,
             required: bool) -> dict:
    out = {}
    for entry in entries:
        value = reader(root, entry["name"])(run)
        if value is None:
            if required:
                raise RuntimeError(f"{entry['name']}: nothing to read")
            continue
        out[entry["name"]] = {"value": float(value), "unit": entry["unit"]}
    return out


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             root: Path = ROOT, device: str = "cuda",
             overrides: dict | None = None,
             t0: float | None = None) -> dict:
    """Run cell ``name`` once; returns the result line's object.

    ``overrides`` replace entries of the configuration (``"config"``) and
    of the traffic's parameters (``"params"``): the CPU tests' cut."""
    t0 = time.perf_counter() if t0 is None else t0
    cell = resolve_cell(name, root)
    overrides = overrides or {}
    config = {**cell.config, **overrides.get("config", {})}
    params = {**cell.traffic["params"], **overrides.get("params", {})}
    import torch
    cuda = torch.device(device).type == "cuda"
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cuda and cards < cell.chips:
        raise NoCard(f"{name} needs {cell.chips} card(s); torch sees "
                     f"{cards}")
    from . import spans
    from .trace import summarize
    from .window import Window

    kernels_s = 0.0
    if cuda and getattr(cell.driver, "BUILDS_KERNELS", True):
        # build the kernels, or load them from the build cache
        from repro_torch.kernels import build
        t_kernels = time.perf_counter()
        build.launcher("mulmod")
        kernels_s = time.perf_counter() - t_kernels
    driver = cell.driver.Driver(config, params, seed, device)
    driver.setup()
    window = Window(device, trace)
    outcome = driver.run(seconds, window)
    setup_s = window.t_open - t0
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    summary = None
    if trace:
        from torch.autograd import DeviceType
        t_trace = time.perf_counter()
        summary = summarize(window.prof.profiler.kineto_results.events(),
                            DeviceType.CUDA if cuda else DeviceType.CPU,
                            labels=spans.labels())
        window.prof = None
        trace_s = time.perf_counter() - t_trace
    del driver
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_judge = time.perf_counter()
    judge = getattr(cell.driver, "judge", None)
    if judge is None:
        from .reference.admm import judge
    verdict = judge(outcome, config)
    reference_s = time.perf_counter() - t_judge
    run = RunRecord(
        tenants=len(outcome.tenants), rounds=outcome.rounds,
        laps=outcome.laps, window_s=outcome.window_s, setup_s=setup_s,
        launches=window.launches, shape_launches=window.shape_launches,
        serve=outcome.serve, trace=summary, inputs=verdict["inputs"],
        counts=outcome.counts)
    if trace:
        metrics = _metrics(cell.per_layer, run, cell.root, required=False)
    else:
        metrics = _metrics(cell.end_to_end, run, cell.root, required=True)
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips if cuda else 0,
           "memory_peak_bytes": int(memory_peak)}
    if summary is not None:
        dev.update(busy_s=summary.busy_s, window_s=summary.window_s)
    result = {"correct": verdict["correct"],
              "attempted": verdict["attempted"],
              "failed": verdict["failed"], "metrics": metrics,
              "device": dev}
    if summary is not None:
        result["breakdown"] = {"device_ops": summary.device_ops,
                               "idle_gaps": summary.idle_gaps}
    result["run"] = {"seed": seed, "rounds": outcome.rounds,
                     "tenant_rounds": run.tenant_rounds, **outcome.counts,
                     "window_s": outcome.window_s, "setup_s": setup_s,
                     "kernels_s": kernels_s, "reference_s": reference_s,
                     "launches": window.launches, "laps": outcome.laps}
    if summary is not None:
        result["run"].update(trace_s=trace_s,
                             span_device_s=summary.span_device_s,
                             gemm_device_s=summary.gemm_device_s)
    result["checks"] = verdict["checks"]
    for check, v in verdict["checks"].items():
        print(f"{check} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr, flush=True)
    return result
