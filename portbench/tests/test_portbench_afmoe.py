"""The afmoe train cell's yardstick on the CPU, at Trinity-Mini's
``reduced()`` sizes (8 layers, 2 of them dense, 8 experts of which 2 a
token, a window of 8, a 64-id vocabulary): the plain reference
(``reference/afmoe.py``) against the port's losses, gradients, AdamW
steps and selection biases; the expert share against the uncut layer;
the float8 control and the planted faults against the cell's own
comparison."""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import pytest
import torch

from portbench import bench, control_train
from portbench.reference import afmoe

ROOT = Path(__file__).resolve().parents[2]
CELL = "trinity_mini_d8.train8k"


def tiny(**over) -> dict:
    """The configuration file's keys at ``configs/trinity_mini.reduced()``
    sizes, every expert held."""
    from repro_torch.configs import trinity_mini
    small = trinity_mini.reduced()
    keys = ("n_layers", "d_model", "n_heads", "n_kv", "head_dim", "d_ff",
            "moe_d_ff", "vocab", "n_experts", "top_k", "window",
            "pad_vocab_multiple")
    return {**{k: getattr(small, k) for k in keys}, "experts_held": 0,
            **over}


def _config(**over) -> dict:
    return {**json.loads((ROOT / "portbench/configs/trinity_mini_d8.json")
                         .read_text()), **tiny(dtype="float32", **over)}


def _batches(vocab: int, seq: int, n: int = 3):
    gen = torch.Generator().manual_seed(6)
    out = []
    for _ in range(n):
        ids = torch.randint(0, vocab, (2, seq + 1), generator=gen)
        out.append((ids[:, :-1], ids[:, 1:]))
    return out


def _worst(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("seq,layers,steps", [(32, 8, 3), (2048, 4, 1)],
                         ids=["naive", "flash"])
def test_reference_equals_the_ports_training(seq, layers, steps):
    """In float32 the program and the reference agree on the first
    step's loss and every gradient leaf (each element within 1e-4 of its
    leaf's largest), then on three steps of ``make_train_step`` (the
    losses within 1e-5, every leaf's change within 1e-3 of its norm: Adam
    divides by the root of the second moment, so a leaf's smallest
    gradients' rounding shows in their steps) and on each layer's
    selection bias after them, to the bit.
    At 2,048 positions (4 layers: W W W F, the last two MoE; one step) the
    windowed layers take ``attention_flash``'s chunk skip."""
    from repro_torch.models import registry
    from repro_torch.train import loop, optimizer
    from portbench.drivers import train
    config = _config(n_layers=layers)
    config["optimizer"] = dict(config["optimizer"], lr=1e-3)
    cfg = train.model_config(config)
    state = loop.init_train_state(cfg, 0, "cpu")
    params = afmoe.make_params(config, 5, "cpu")
    train.load(state["params"], params)
    batches = _batches(config["vocab"], seq, steps)

    tokens, labels = batches[0]
    got = registry.get_model(cfg).loss_fn(
        state["params"], {"tokens": tokens, "labels": labels}, cfg)
    got.backward()
    for p in params.values():
        p.requires_grad_(True)
    bias, counts = afmoe.zero_bias(config, "cpu"), {}
    want = afmoe.loss(params, tokens, labels, config, bias, counts)
    want.backward()
    got, want = float(got.detach()), float(want.detach())
    assert abs(got - want) <= 1e-5 * abs(want)
    for name, p in state["params"].named_parameters():
        ref = params[name].grad
        assert ref.abs().max() > 0, name
        assert _worst(p.grad, ref) <= 1e-4, name
    state["params"].zero_grad(set_to_none=True)
    for i, lp in enumerate(state["params"]["layers"]):
        if "moe" in lp:           # the forward's counts, then no step
            assert torch.equal(lp["moe"]["counts"], counts[i])
            lp["moe"]["counts"].zero_()

    start = {n: p.detach().clone() for n, p in params.items()}
    step = loop.make_train_step(cfg, optimizer.OptConfig(
        **config["optimizer"]))
    losses = []
    for tokens, labels in batches:
        state, met = step(state, {"tokens": tokens, "labels": labels})
        losses.append(float(met["loss"]))
    ref_params = {n: p.clone() for n, p in start.items()}
    ref = afmoe.follow(config, config["optimizer"], ref_params, batches)
    for a, b in zip(losses, ref["losses"]):
        assert abs(a - b) <= 1e-5 * abs(b)
    for name, p in state["params"].named_parameters():
        mine, want = p.detach() - start[name], ref_params[name] - start[name]
        assert (mine - want).norm() <= 1e-3 * want.norm(), name
    moe_layers = [i for i, lp in enumerate(state["params"]["layers"])
                  if "moe" in lp]
    assert moe_layers == list(range(2, layers)) == sorted(ref["bias"])
    for i in moe_layers:
        b = state["params"]["layers"][i]["moe"]["bias"]
        assert torch.equal(b, ref["bias"][i]), i
        assert b.abs().max() > 0
        assert not state["params"]["layers"][i]["moe"]["counts"].any()


def test_expert_shares_add_up_to_the_uncut_layer():
    """Four cards of two experts each (``experts_first`` 0, 2, 4, 6),
    each computing its experts' part for the tokens routed to them plus
    the shared expert: their outputs, the shared expert counted once,
    add up to the reference's layer with all eight experts."""
    from repro_torch.models import layers as L
    from repro_torch.models import moe
    from portbench.drivers import train
    config = _config()
    cfg = train.model_config(config)
    full = afmoe.make_params(config, 3, "cpu")
    p = {k[len("layers.2."):]: t for k, t in full.items()
         if k.startswith("layers.2.moe.")}
    h = torch.randn(2, 16, cfg.d_model, generator=torch.Generator()
                    .manual_seed(4))
    bias = torch.linspace(-0.01, 0.01, cfg.n_experts)
    with torch.no_grad():
        want = afmoe.experts(h, p, config, torch.matmul, bias, {}, 2)
        shared = afmoe.swiglu(h, p["moe.shared.w_gate"],
                              p["moe.shared.w_up"], p["moe.shared.w_down"],
                              torch.matmul)
        total = torch.zeros_like(want)
        for first in range(0, 8, 2):
            share = dataclasses.replace(cfg, experts_held=2,
                                        experts_first=first)
            tree = L.Params({
                "router": p["moe.router"],
                "we_gate": p["moe.we_gate"][first:first + 2],
                "we_up": p["moe.we_up"][first:first + 2],
                "we_down": p["moe.we_down"][first:first + 2],
                "shared": {n: p[f"moe.shared.{n}"]
                           for n in ("w_gate", "w_up", "w_down")}})
            moe.add_bias_state(tree, share)
            tree["bias"].copy_(bias)
            total += moe.moe_block(tree, h, share) - shared
    assert _worst(total + shared, want) <= 1e-5


def _fp8_control_fails(seed: int, cell, limits) -> None:
    train = cell.driver
    feed = train.batches(cell.config, cell.traffic["params"], seed, "cpu")
    payload = {"seed": seed, "device": "cpu", "steps": 0,
               "window_losses": [], "batches": [next(feed) for _ in range(3)]}
    ref = train.reference_readings(cell.config, payload)
    fp8 = train.reference_readings(cell.config, payload, mm=afmoe.fp8_mm)
    assert train.compare({**payload, **fp8}, ref, limits)["correct"] is False
    assert train.compare({**payload, **ref}, ref, limits)["correct"]


def _cell():
    cell = bench.resolve_cell(CELL)
    cell.config.update(tiny(experts_held=4))
    cell.traffic["params"].update(seq=32)
    return cell


def test_the_float8_control_is_not_correct():
    """The reference with every matrix product's operands rounded to
    float8 in the program's place fails the cell's limits on three
    seeds; the reference in float32 there passes them."""
    cell = _cell()
    limits = {k: v["limit"] for k, v in cell.config["limits"].items()}
    for seed in (11, 12, 2 ** 31 + 13):
        _fp8_control_fails(seed, cell, limits)


@pytest.mark.parametrize("fault", list(control_train.FAULTS))
def test_a_planted_fault_is_not_correct(fault):
    """The program with a fault planted for the whole run comes out not
    correct in the afmoe cell too."""
    with control_train.planted(fault):
        result = bench.run_cell(CELL, 99, 0.05, False, device="cpu",
                                overrides={"config": tiny(experts_held=4,
                                                          dtype="float32"),
                                           "params": {"seq": 32}})
    assert result["correct"] is False
    assert result["failed"] > 0


def test_a_run_reads_the_moe_layers_metrics():
    """A traced run of the cell at the small size is correct and reads
    both MoE metrics: on the CPU the grouped product's loop reads the
    group ends back once a product (three a layer call)."""
    result = bench.run_cell(CELL, 2 ** 31 + 7, 0.05, True, device="cpu",
                            overrides={"config": tiny(experts_held=4,
                                                      dtype="float32"),
                                       "params": {"seq": 32}})
    assert result["correct"], result["checks"]
    metrics = result["metrics"]
    assert metrics["moe_waits_per_call.train"]["value"] == 3.0
    assert metrics["moe_host_s.train"]["value"] >= 0.0


def test_the_moe_readers_on_hand_made_counts(monkeypatch):
    """``moe_host_s.train``: the idle seconds charged to ``moe.*`` spans
    over the steps, ``None`` without a trace or where the program names
    no such span (the parent's); ``moe_waits_per_call.train``: the
    ``wait.moe.*`` counts over ``moe.calls``, ``None`` where the layer
    never ran."""
    from portbench.trace import TraceSummary
    from repro_torch.obs import metrics, trace
    gaps = [["moe.route", 0.5], ["moe.bias", 0.25], ["transformer.block",
                                                      4.0], ["aten::mm", 1.0]]
    summary = TraceSummary(window_s=20.0, busy_s=15.0, function_s={},
                           device_ops=[], idle_gaps=gaps)

    def run(trace_summary):
        return bench.RunRecord(tenants=0, rounds=0, laps=[1.0] * 5,
                               window_s=5.0, setup_s=1.0, launches={},
                               shape_launches={}, serve=None,
                               trace=trace_summary, inputs={},
                               counts={"steps": 5, "tokens": 80})
    host = bench.reader(ROOT, "moe_host_s.train")
    waits = bench.reader(ROOT, "moe_waits_per_call.train")
    assert host(run(summary)) == pytest.approx(0.75 / 5)
    assert host(run(None)) is None
    monkeypatch.setattr(metrics.PROCESS, "counters", {})
    assert waits(run(None)) is None
    metrics.PROCESS.counters.update({"moe.calls": 8, "wait.lap": 3})
    assert waits(run(None)) == 0.0
    metrics.PROCESS.counters["wait.moe.offsets"] = 24
    assert waits(run(None)) == 3.0
    monkeypatch.setattr(trace, "SPANS", tuple(
        n for n in trace.SPANS if not n.startswith("moe.")))
    assert host(run(summary)) is None


def test_the_afmoe_control_script_reads_every_variant():
    """``control_afmoe`` at the small size gives a line for each variant;
    the reference that takes the program's choices ends on the program's
    selection biases to the bit, a frozen bias ends apart from the
    reference's, and the float8 control is not correct."""
    from portbench import control_afmoe
    rows = {r["variant"]: r
            for r in control_afmoe.readings(_cell(), [5], "cpu")}
    assert set(rows) == {"sound", "bias_frozen", "bias_flipped",
                         "control_fp8", "sound_fixed", "control_fp8_fixed"}
    assert rows["sound_fixed"]["bias_entries_differ"] == 0
    assert rows["bias_frozen"]["bias_gap"] > 0
    assert rows["control_fp8"]["correct"] is False
    assert all(len(r["worst_grad"]) == 3 for r in rows.values())
