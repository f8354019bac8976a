"""A run whose timed path is broken underneath comes out not correct.

Each fault is planted in the program's Paillier-batch layer for the whole
run, and the rest of the run (set-up, window, reference, comparison) is
the harness's own, on the CPU at a tiny cut: a sum that returns its state
unchanged, a matvec that leaves out half of each row's terms, one
decrypted answer altered where it is produced, and a serving engine that
hands tenants each other's answers."""
from __future__ import annotations

import numpy as np
import pytest

from portbench import bench
from repro_torch.core import paillier_batch as pb

RUNTIME = ("fig7_k10.runtime", {"M": 8, "N": 80, "key_bits": 80})
SERVE = ("fig6_k3.serve4", {"M": 8, "N": 24, "key_bits": 80})


def _unchanged(real):
    def add_ct(bk, c1, c2):
        return c1
    return add_ct


def _half_terms(real):
    def matvec_many(bk, Ks, cs_list):
        Ks = np.array(Ks, dtype=object)
        Ks[..., Ks.shape[-1] // 2:] = 0
        return real(bk, Ks, cs_list)
    return matvec_many


def _altered(real):
    def dec_vec(bk, cs):
        out = real(bk, cs)
        out[0] += out[0] // 1000 + 1
        return out
    return dec_vec


def _swapped(real):
    def dec_rows(items, device=None):
        out = real(items, device)
        return out[1:] + out[:1]
    return dec_rows


@pytest.mark.parametrize("cell,cut,target,fault", [
    (*RUNTIME, "add_ct", _unchanged),
    (*RUNTIME, "matvec_many", _half_terms),
    (*RUNTIME, "dec_vec", _altered),
    (*SERVE, "dec_rows", _swapped),
], ids=["sum_unchanged", "half_the_terms", "answer_altered",
        "tenants_swapped"])
def test_a_planted_fault_is_not_correct(monkeypatch, cell, cut, target,
                                        fault):
    monkeypatch.setattr(pb, target, fault(getattr(pb, target)))
    result = bench.run_cell(cell, 99, 0.01, False, device="cpu",
                            overrides={"config": cut,
                                       "params": {"warmup_rounds": 1,
                                                  "least_rounds": 2}})
    assert result["correct"] is False
    assert result["failed"] > 0
    assert result["checks"]["history_gap"]["value"] > 0
