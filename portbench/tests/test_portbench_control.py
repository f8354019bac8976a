"""The control fails the comparison that decides ``correct``: the plain
reference in float32 in place of the program, at each configuration's
own size, on three seeds, judged by the harness's ``reference.admm.judge``; the
float64 reference in the program's place passes it."""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest

from portbench.control import control_verdict

ROOT = Path(__file__).resolve().parents[2]
#: the LASSO configurations (a train cell's control: test_portbench_lm)
CONFIGS = [c["name"] for c in
           json.loads((ROOT / "BENCHMARK.json").read_text())["configs"]
           if "M" in json.loads((ROOT / c["file"]).read_text())]


@pytest.mark.parametrize("config", CONFIGS)
def test_the_float32_control_is_not_correct(config):
    cfg = json.loads((ROOT / f"portbench/configs/{config}.json").read_text())
    for seed in (11, 12, 2 ** 31 + 13):
        verdict = control_verdict(cfg, 1, seed, rounds=4)
        assert verdict["correct"] is False
        assert verdict["checks"]["history_gap"]["value"] > 0
        assert control_verdict(cfg, 1, seed, rounds=2,
                               dtype=np.float64)["correct"] is True
