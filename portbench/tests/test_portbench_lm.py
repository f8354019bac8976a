"""The train cells' yardstick on the CPU: the plain reference
(``reference/lm.py``) against the port's loss and gradients, the model
FLOPs count against a count by hand, the float8 control and the planted
faults against the cell's own comparison, and the LASSO cells' verdict
through the judge's dispatch."""
from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from portbench import bench, control_train, counts
from portbench.reference import admm, lm

ROOT = Path(__file__).resolve().parents[2]
CELL = "yi9b_d8.train"
#: Yi-9B's reduced() sizes (repro_torch.configs.yi_9b.reduced)
TINY = {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv": 2, "d_ff": 128,
        "vocab": 256}


def _cell(**config):
    cell = bench.resolve_cell(CELL)
    cell.config.update(TINY, **config)
    cell.traffic["params"].update(seq=16)
    return cell


@pytest.mark.parametrize("seq", [16, 2048], ids=["naive", "flash"])
def test_reference_equals_the_ports_loss_and_gradients(seq):
    """In float32 the reference's loss and every leaf's gradient equal
    the port's ``loss_fn`` (remat on; ``attention_naive`` below 2,048
    positions, ``attention_flash`` from there) to float32 rounding: the
    loss within 1e-5 of itself, each gradient element within 1e-4 of its
    leaf's largest (the two sum in other orders)."""
    from repro_torch.models import registry
    from repro_torch.train import loop
    from portbench.drivers import train
    config = {**json.loads((ROOT / "portbench/configs/yi9b_d8.json")
                           .read_text()), **TINY, "dtype": "float32"}
    cfg = train.model_config(config)
    state = loop.init_train_state(cfg, 0, "cpu")
    params = lm.make_params(config, 5, "cpu")
    train.load(state["params"], params)
    gen = torch.Generator().manual_seed(6)
    ids = torch.randint(0, config["vocab"], (1, seq + 1), generator=gen)
    batch = {"tokens": ids[:, :-1], "labels": ids[:, 1:]}
    got = registry.get_model(cfg).loss_fn(state["params"], batch, cfg,
                                          remat=True, use_scan=True)
    got.backward()
    for p in params.values():
        p.requires_grad_(True)
    want = lm.loss(params, batch["tokens"], batch["labels"], config)
    want.backward()
    got, want = float(got.detach()), float(want.detach())
    assert abs(got - want) <= 1e-5 * abs(want)
    for name, p in state["params"].named_parameters():
        ref = params[name].grad
        assert ref.abs().max() > 0, name
        assert (p.grad - ref).abs().max() <= 1e-4 * ref.abs().max(), name


def test_mfu_count_by_hand():
    """PaLM's count at Yi-9B's reduced() sizes, 32 tokens in sequences
    of 16: per layer q, k, v, o 64 x 16 x (2 x 4 + 2 x 2) = 12,288, the MLP
    3 x 64 x 128 = 24,576 and two norms 128; two layers, the final norm 64
    and the head 64 x 256 = 16,384 make N = 90,432 (the embedding table
    apart); 6 N T = 17,362,944 and 12 L H hd S T = 786,432."""
    model = {**TINY, "name": "tiny"}
    assert counts.lm_nonembedding_params(model) == 90_432
    assert counts.lm_train_flops(model, 16, 32) == 17_362_944 + 786_432
    yi = json.loads((ROOT / "portbench/configs/yi9b_d8.json").read_text())
    assert counts.lm_nonembedding_params(yi) == 8 * (
        4096 * 128 * (2 * 32 + 2 * 4) + 3 * 4096 * 11008 + 2 * 4096) \
        + 4096 + 4096 * 64000


def test_the_float8_control_is_not_correct():
    """The reference with every matrix product's operands rounded to
    float8 in the program's place fails the cell's limits on three seeds;
    the reference in float32 there passes them."""
    cell = _cell()
    limits = {k: v["limit"] for k, v in cell.config["limits"].items()}
    train = cell.driver
    for seed in (11, 12, 2 ** 31 + 13):
        feed = train.batches(cell.config, cell.traffic["params"], seed,
                             "cpu")
        payload = {"seed": seed, "device": "cpu", "steps": 0,
                   "window_losses": [],
                   "batches": [next(feed) for _ in range(3)]}
        ref = train.reference_readings(cell.config, payload)
        fp8 = train.reference_readings(cell.config, payload, mm=lm.fp8_mm)
        assert train.compare({**payload, **fp8}, ref, limits)["correct"] \
            is False
        assert train.compare({**payload, **ref}, ref, limits)["correct"]


@pytest.mark.parametrize("fault", list(control_train.FAULTS))
def test_a_planted_fault_is_not_correct(fault):
    """The program with a fault planted for the whole run (a step that
    leaves the state as it was, the loss over half of the batch, the
    loss's value altered where it is produced) comes out not correct."""
    with control_train.planted(fault):
        result = bench.run_cell(CELL, 99, 0.05, False, device="cpu",
                                overrides={"config": {**TINY,
                                                      "dtype": "float32"},
                                           "params": {"seq": 16}})
    assert result["correct"] is False
    assert result["failed"] > 0


def test_the_control_script_reads_sound_runs_faults_and_the_control():
    cell = _cell(dtype="float32")
    records = list(control_train.readings(cell, [3, 4], 1, "cpu"))
    assert [(r["seed"], r["variant"]) for r in records] == [
        (3, "sound"), (3, "state_unchanged"), (3, "half_batch"),
        (3, "answer_altered"), (3, "control_fp8"), (4, "sound")]
    assert [r["correct"] for r in records] == [True, False, False, False,
                                               False, True]
    unchanged = records[1]["checks"]
    assert unchanged["grad_gap"] == unchanged["change_gap"] == 1.0


def test_lasso_cells_keep_their_verdict_through_the_dispatch(monkeypatch,
                                                             capsys):
    """A driver without a judge of its own is judged by
    ``reference.admm.judge``: the verdict, checks and standard-error
    lines are that judge's, and the rooflines' inputs are its."""
    seen = []
    real = admm.judge

    def spy(outcome, config):
        seen.append(real(outcome, config))
        return seen[-1]
    monkeypatch.setattr(admm, "judge", spy)
    result = bench.run_cell("fig7_k10.solo", 2 ** 31 + 11, 0.01, False,
                            device="cpu",
                            overrides={"config": {"M": 8, "N": 40,
                                                  "key_bits": 80},
                                       "params": {"warmup_rounds": 1,
                                                  "least_rounds": 2}})
    [verdict] = seen
    assert result["checks"] == verdict["checks"] == {
        "history_gap": {"value": 0.0, "limit": 0.0},
        "rounds_missing": {"value": 0, "limit": 0}}
    assert (result["correct"], result["attempted"], result["failed"]) == \
        (verdict["correct"], verdict["attempted"], verdict["failed"])
    assert verdict["inputs"]["nk"] == 4 and verdict["inputs"]["key_bits"] \
        == 80
    err = capsys.readouterr().err.strip().splitlines()
    assert err[-2:] == ["history_gap 0.0 limit 0.0",
                        "rounds_missing 0 limit 0"]


class _Event:
    """One profiler event, as ``trace.summarize`` reads it."""

    def __init__(self, name, start, end, tid=1, device=False, seq=-1,
                 corr=0, linked=0):
        self._v = (name, start, end - start, tid, device, seq, corr, linked)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def start_thread_id(self):
        return self._v[3]

    def device_type(self):
        from torch.autograd import DeviceType
        return DeviceType.CUDA if self._v[4] else DeviceType.CPU

    def sequence_nr(self):
        return self._v[5]

    def correlation_id(self):
        return self._v[6]

    def linked_correlation_id(self):
        return self._v[7]

    def is_user_annotation(self):
        return False


def test_device_time_is_charged_to_the_span_that_launched_it():
    """A kernel goes to the harness span around the operator it is linked
    to: in the forward, under the span; in the backward, through the
    node's sequence number to the forward operator's span; in a block
    recomputed inside the backward, under the span again."""
    from torch.autograd import DeviceType
    from portbench import spans, trace
    back = trace.BACKWARD
    ev = [
        _Event(trace.OPEN, 0, 0), _Event(trace.CLOSE, 1000, 1000),
        # forward, thread 1: attention's product, then the MLP's
        _Event("transformer.block", 10, 100),
        _Event("layers.attention", 20, 60),
        _Event("aten::bmm", 25, 30, seq=5, corr=101),
        _Event("aten::mm", 70, 80, seq=6, corr=102),
        # backward, thread 2: the two nodes, a recomputed block inside
        _Event(back + "BmmBackward0", 200, 300, tid=2, seq=5),
        _Event("aten::bmm", 210, 220, tid=2, corr=103),
        _Event("transformer.block", 230, 290, tid=2),
        _Event("layers.attention", 240, 250, tid=2),
        _Event("aten::bmm", 241, 245, tid=2, seq=9, corr=104),
        _Event("aten::mm", 260, 270, tid=2, seq=10, corr=105),
        _Event(back + "MmBackward0", 300, 350, tid=2, seq=6),
        _Event("aten::mm", 310, 320, tid=2, corr=106),
        # the device: (name, ns) linked to each operator
        _Event("sm80_xmma_gemm_f32f32", 400, 410, device=True, linked=101),
        _Event("nvjet_tst_bf16", 410, 430, device=True, linked=102),
        _Event("cutlass_80_simt_sgemm", 430, 460, device=True, linked=103),
        _Event("exp_kernel", 460, 465, device=True, linked=104),
        _Event("nvjet_tst_bf16", 465, 472, device=True, linked=105),
        _Event("nvjet_tst_bf16", 472, 483, device=True, linked=106),
    ]
    got = trace.summarize(ev, DeviceType.CUDA, labels=spans.labels())
    assert got.span_device_s == pytest.approx(
        {"layers.attention": 45e-9, "transformer.block": 38e-9})
    assert got.gemm_device_s == pytest.approx(
        {"layers.attention": 40e-9, "transformer.block": 38e-9})
    assert got.device_s == pytest.approx(83e-9)
    run = bench.RunRecord(tenants=0, rounds=0, laps=[], window_s=1e-6,
                          setup_s=0.0, launches={}, shape_launches={},
                          serve=None, trace=got, inputs={})
    assert bench.reader(ROOT, "attention_share.train")(run) == \
        pytest.approx(100 * 45 / 83)
    assert bench.reader(ROOT, "matmul_share.train")(run) == \
        pytest.approx(100 * 38 / 83)
    assert bench.reader(ROOT, "adamw_share.train")(run) is None
