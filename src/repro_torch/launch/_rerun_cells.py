"""Re-run selected dry-run cells and merge them into an existing report
(a dev tool: it patches cells recorded before a fix to the method).

Port of ``repro.launch._rerun_cells``: the named ``arch/shape`` cells run
through ``dryrun.run_cell`` on the fake production group (16 x 16, or
2 x 16 x 16 with ``--multi-pod``) and replace their entries in the
report.  It refuses a report with a cell that another torch release
produced (or one that names none): DTensor picks other strategies in
other releases, so such a report would mix numbers of two releases.

Usage:
  python -m repro_torch.launch._rerun_cells --cells yi_9b/train_4k[,arch/shape...]
      [--report reports/dryrun.json] [--multi-pod] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os

import torch

from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_mod


def foreign_cells(report: dict) -> list[str]:
    """The cells of ``report`` that ran under another torch release than
    this one, or under an unrecorded one."""
    return sorted(k for k, v in report.items()
                  if v.get("status") != "skipped"
                  and v.get("torch") != torch.__version__)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--report", default="reports/dryrun.json")
    ap.add_argument("--cells", required=True,
                    help="comma list arch/shape[,arch/shape...]")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="the mesh's device type (cuda or cpu)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    report = {}
    if os.path.exists(args.report):
        with open(args.report) as f:
            report = json.load(f)
    foreign = foreign_cells(report)
    if foreign:
        raise SystemExit(
            f"_rerun_cells: {len(foreign)} cell(s) of {args.report} were "
            f"not produced by torch {torch.__version__} (first: "
            f"{foreign[0]}, torch {report[foreign[0]].get('torch')}); "
            f"re-run the whole report instead")
    patch: dict = {}
    with mesh_mod.fake_group(512 if args.multi_pod else 256):
        mesh = mesh_mod.make_production_mesh(multi_pod=args.multi_pod,
                                             device=args.device)
        for cell in args.cells.split(","):
            arch, shape = cell.split("/")
            dryrun.run_cell(arch, shape, mesh, report=patch)
    report.update(patch)
    os.makedirs(os.path.dirname(args.report) or ".", exist_ok=True)
    with open(args.report, "w") as f:
        json.dump(report, f, indent=1)
    print(f"patched {len(patch)} cells -> {args.report}")
    return patch


if __name__ == "__main__":
    main()
