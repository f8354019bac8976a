"""Run one cell of the port's benchmark once; print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell
names in ``BENCHMARK.json``.  The last line of standard output is the
result's JSON object; the numbers compared for ``correct`` come last on
standard error, each beside its limit.  Exits non-zero with no result
when the cards are missing, when the program's package is not beside
this folder (``src/repro_torch``), or when the process loaded JAX or
the JAX package.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def environment() -> None:
    """The run's environment: no run-history ledger (it would write under
    ``~/.cache``) and the program's own defaults for its kernel knobs."""
    os.environ["REPRO_LEDGER"] = "off"
    for knob in ("REPRO_REDUCE_IMPL", "REPRO_MODEXP_METHOD"):
        os.environ.pop(knob, None)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    environment()
    import repro_torch  # noqa: F401  (the program: src/repro_torch)
    from portbench import bench
    try:
        result = bench.run_cell(args.workload, args.seed, args.seconds,
                                bool(args.trace), t0=T0)
    except bench.NoCard as err:
        print(f"portbench: {err}", file=sys.stderr)
        return 2
    found = bench.forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}", file=sys.stderr)
        return 2
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
