"""The port's sharding specs, roofline and dry-run against the JAX
reference, in one process on the CPU.

Specs are compared exactly: ``param_pspecs`` for every architecture at
its full configuration (the reference's from ``jax.eval_shape``, the
port's from ``meta`` tensors: nothing is allocated), with the leading
``None`` of the reference's layer-stacked leaves dropped; ``input_specs``,
``cache_specs`` (``REPRO_KV_QUANT`` off and on) and ``input_shardings``
for every (arch x shape) cell in shape, dtype and spec; ``model_flops``
and ``cell_correction`` for every cell.  The dry-run runs on PyTorch's
fake process group (one process playing rank 0 of the mesh) over
``meta`` tensors; its counted flops are held against hand counts.
"""
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

from repro.analysis import corrections as ref_corrections
from repro.analysis import roofline as ref_roofline
from repro.configs import ARCHS, get_config as ref_config
from repro.models import registry as ref_registry
from repro_torch.analysis import corrections, roofline
from repro_torch.configs import get_config, get_reduced
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import layers as L
from repro_torch.models import registry

MESHES = [{"data": 16, "model": 16}, {"data": 2, "model": 2}]


def _ref_specs(tree) -> dict:
    """Reference spec leaves by ``/``-joined key path, as tuples."""
    out = {}
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    for path, spec in flat:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        out[key] = tuple(spec)
    return out


def _port_leaves(tree, prefix="") -> dict:
    out = {}
    if isinstance(tree, L.Params):
        tree = tree.tree()
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_port_leaves(v, f"{prefix}{k}/"))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            out.update(_port_leaves(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unstacked(ref: dict, n_layers: dict) -> dict:
    """The reference's specs keyed as the port's leaves: a leaf of a
    stacked subtree (``layers/attn/wq``) once per layer
    (``layers/<i>/attn/wq``) with its layer dim's ``None`` dropped."""
    out = {}
    for key, spec in ref.items():
        head, _, rest = key.partition("/")
        if head in L.STACKED and head in n_layers:
            assert not spec or spec[0] is None, (key, spec)
            spec = list(spec[1:])
            while spec and spec[-1] is None:
                spec.pop()
            for i in range(n_layers[head]):
                out[f"{head}/{i}/{rest}"] = tuple(spec)
        else:
            out[key] = spec
    return out


@pytest.mark.parametrize("mesh_shape", MESHES,
                         ids=lambda m: "x".join(map(str, m.values())))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_pspecs_match_reference_at_full_config(arch, mesh_shape):
    rcfg, cfg = ref_config(arch), get_config(arch)
    shapes = jax.eval_shape(lambda: ref_registry.get_model(rcfg).init(
        rcfg, jax.random.PRNGKey(0)))
    ref = _ref_specs(ref_registry.param_pspecs(rcfg, shapes, mesh_shape))
    params = L.Params(registry.family_module(cfg).param_tree(
        cfg, L.ShapeInit()))
    got = _port_leaves(registry.param_pspecs(cfg, params, mesh_shape))
    stacked = {k: len(v) for k, v in params.tree().items()
               if k in L.STACKED and isinstance(v, list)}
    want = _unstacked(ref, stacked)
    assert sorted(got) == sorted(want)
    for key, spec in got.items():
        assert isinstance(spec, registry.P)
        assert tuple(spec) == want[key], key


def _ref_leaves(tree) -> dict:
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(
                x, jax.sharding.PartitionSpec))[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        out[key] = leaf
    return out


@pytest.mark.parametrize("quant", ["0", "1"])
@pytest.mark.parametrize("arch", ARCHS)
def test_input_and_cache_specs_match_reference(arch, quant, monkeypatch):
    """Every shape of the arch: stand-ins in shape and dtype, their specs
    on the production mesh and on a multi-pod one (dp over pod and
    data), and a decode cache with its cross K/V."""
    monkeypatch.setenv("REPRO_KV_QUANT", quant)
    rcfg, cfg = ref_config(arch), get_config(arch)
    multi = {"pod": 2, "data": 16, "model": 16}
    for shape in registry.SHAPES:
        ref = ref_registry.input_specs(rcfg, shape)
        got = registry.input_specs(cfg, shape)
        r, g = _ref_leaves(ref), _port_leaves(got)
        assert sorted(r) == sorted(g), shape
        for k in r:
            assert tuple(g[k].shape) == tuple(r[k].shape), (shape, k)
            assert str(g[k].dtype) == f"torch.{r[k].dtype}", (shape, k)
            assert g[k].device.type == "meta"
        for dpx, ms in ((("data",), None), (("pod", "data"), multi)):
            rs = _ref_leaves(ref_registry.input_shardings(rcfg, shape, ref,
                                                          dpx, ms))
            gs = _port_leaves(registry.input_shardings(cfg, shape, got, dpx,
                                                       ms))
            assert {k: tuple(v) for k, v in gs.items()} \
                == {k: tuple(v) for k, v in rs.items()}, (shape, dpx)
    rc = _ref_leaves(ref_registry.cache_specs(rcfg, 8, 64, with_cross=True))
    gc = _port_leaves(registry.cache_specs(cfg, 8, 64, with_cross=True))
    assert {k: (tuple(v.shape), f"torch.{v.dtype}") for k, v in rc.items()} \
        == {k: (tuple(v.shape), str(v.dtype)) for k, v in gc.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_and_corrections_match_reference(arch):
    rcfg, cfg = ref_config(arch), get_config(arch)
    for shape, sh in registry.SHAPES.items():
        assert roofline.model_flops(cfg, sh["kind"], sh["seq"], sh["batch"]) \
            == ref_roofline.model_flops(rcfg, sh["kind"], sh["seq"],
                                        sh["batch"])
        assert corrections.cell_correction(cfg, shape) \
            == ref_corrections.cell_correction(rcfg, shape)


def test_analyze_prices_at_the_h100():
    colls = roofline.collective_bytes([("all-gather", 450e9),
                                       ("all-reduce", 450e9)])
    rl = roofline.analyze({"flops": 989e12, "bytes accessed": 6.7e12},
                          colls, 4, model_flops_total=989e12)
    assert rl.t_compute == pytest.approx(1.0)
    assert rl.t_memory == pytest.approx(2.0)
    assert rl.t_collective == pytest.approx(900e9 / (18 * 25e9))
    assert rl.bottleneck == "memory"
    assert rl.useful_ratio == pytest.approx(0.25)
    assert set(rl.as_dict()) == set(
        ref_roofline.Roofline.__dataclass_fields__)
    assert colls["counts"] == {"all-gather": 1, "all-reduce": 1}
    assert set(roofline.COLLECTIVES) == set(ref_roofline._COLLECTIVES)
    rl = roofline.analyze({"flops": 1.0}, colls, 1, 1.0,
                          coll_bytes_override=0.0)
    assert rl.coll_bytes == 0.0 and rl.bottleneck == "compute"


@pytest.fixture
def mesh22():
    with mesh_mod.fake_group(4):
        yield mesh_mod.make_mesh((2, 2), ("data", "model"), "cpu")


def test_make_mesh_and_placements(mesh22):
    assert mesh_mod.mesh_shape_dict(mesh22) == {"data": 2, "model": 2}
    assert mesh_mod.dp_axes(mesh22) == ("data",)
    P = registry.P
    assert registry.placements(P("model", "data"), mesh22) \
        == [Shard(1), Shard(0)]
    assert registry.placements(P(None, "model"), mesh22) \
        == [Replicate(), Shard(1)]
    assert registry.placements(P(), mesh22) == [Replicate(), Replicate()]
    assert registry.placements(P(("data", "model")), mesh22) \
        == [Shard(0), Shard(0)]
    with pytest.raises(ValueError, match="mesh's axis order"):
        registry.placements(P(("model", "data")), mesh22)
    with pytest.raises(ValueError, match="shards two dims"):
        registry.placements(P("data", "data"), mesh22)


def test_multi_pod_mesh_placements():
    with mesh_mod.fake_group(512):
        m = mesh_mod.make_production_mesh(multi_pod=True, device="cpu")
        assert mesh_mod.mesh_shape_dict(m) == {"pod": 2, "data": 16,
                                               "model": 16}
        assert mesh_mod.dp_axes(m) == ("pod", "data")
        assert registry.placements(registry.P(("pod", "data"), None,
                                              "model"), m) \
            == [Shard(0), Shard(0), Shard(2)]


def test_collective_bytes_of_a_sharded_matmul(mesh22):
    """x (8, 64) split over data @ w (64, 32) split over both axes: w is
    gathered over data (a (32, 16) f32 shard grows to (64, 16)), and the
    product comes out split over model; the recorder sees that one
    all-gather of max(result, operand) = 64 * 16 * 4 bytes."""
    x = distribute_tensor(torch.empty(8, 64, device="meta"), mesh22,
                          [Shard(0), Replicate()])
    w = distribute_tensor(torch.empty(64, 32, device="meta"), mesh22,
                          [Shard(0), Shard(1)])
    with roofline.CollectiveRecorder() as rec:
        y = x @ w
    assert y.placements == (Shard(0), Shard(1))
    assert roofline.collective_bytes(rec.records) == {
        "bytes_by_kind": {"all-gather": 64 * 16 * 4},
        "counts": {"all-gather": 1}, "total_bytes": 64 * 16 * 4}


@pytest.mark.parametrize("causal", [False, True])
def test_flash_count_against_the_reference_correction(causal):
    """One ``attention_flash`` call at S = 4,096 under the meter: the
    port runs every (query, key-chunk) block, masked or not, so its
    count is 4 B H hd S T.  That is the true-flops term of the
    reference's ``_flash_delta_one`` (counted + delta) for full
    attention; for causal attention the reference credits the triangle
    S (S + 1) / 2, and the port's count is the square."""
    B, S, H, hd = 1, 4096, 2, 64
    q = torch.empty(B, S, H, hd, device="meta")
    with dryrun.StepMeter() as meter:
        L.attention_flash(q, q[:, :, :1], q[:, :, :1], causal=causal)
    counted = sum(meter.flops.values())
    d_flops, _ = ref_corrections._flash_delta_one(B, S, S, H, hd, causal, 0)
    ref_true = d_flops + 4.0 * B * H * 512 * 512 * hd
    square = 4.0 * B * H * hd * S * S
    assert counted == square
    assert ref_true == (square if not causal
                        else 4.0 * B * H * hd * S * (S + 1) / 2)


def test_constrain_acts(mesh22):
    x = distribute_tensor(torch.empty(4, 6, 8, device="meta"), mesh22,
                          [Shard(0), Replicate()])
    assert L.constrain_acts(x) is x                 # none installed
    L.set_activation_sharding(mesh22, [Shard(0), Shard(2)])
    try:
        y = L.constrain_acts(x)
        assert y.placements == (Shard(0), Shard(2))
        odd = distribute_tensor(torch.empty(4, 6, 7, device="meta"), mesh22,
                                [Shard(0), Replicate()])
        assert L.constrain_acts(odd) is odd         # 7 does not divide
        two = distribute_tensor(torch.empty(4, 8, device="meta"), mesh22,
                                [Shard(0), Replicate()])
        assert L.constrain_acts(two) is two         # not (B, S, D)
        plain = torch.empty(4, 6, 8)
        assert L.constrain_acts(plain) is plain
    finally:
        L.set_activation_sharding(None)


def test_pipeline_rows_on_a_mesh(mesh22):
    """Rank 0 (data coordinate 0) holds the first half of every global
    batch's rows, replicated over model, and the cursor advances."""
    pipe = TokenPipeline(vocab=64, batch=4, seq=8)
    want = TokenPipeline(vocab=64, batch=4, seq=8).next()
    got = pipe.next(device="cpu", mesh=mesh22)
    assert pipe.step == 1
    for k, v in want.items():
        assert isinstance(got[k], DTensor)
        assert got[k].placements == (Shard(0), Replicate())
        assert tuple(got[k].shape) == v.shape
        np.testing.assert_array_equal(got[k].to_local().numpy(), v[:2])


REPORT_KEYS = {"status", "kind", "n_devices", "memory",
               "flops_per_dev_counted", "flops_per_dev", "bytes_per_dev",
               "correction", "collectives", "coll_bytes_per_dev",
               "roofline"}
RENAMED = {"lower_s": "build_s", "compile_s": "run_s"}


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_dryrun_cell_on_a_reduced_config(shape, mesh22):
    rep = {}
    e = dryrun.run_cell("yi_9b", shape, mesh22, report=rep,
                        cfg=dataclasses.replace(get_reduced("yi_9b"),
                                                n_layers=1))
    assert e["status"] == "ok", e.get("trace")
    assert list(rep) == [f"yi_9b/{shape}/2x2"]
    assert REPORT_KEYS | set(RENAMED.values()) <= set(e)
    assert set(e["memory"]) >= {"args_bytes_per_dev", "out_bytes_per_dev",
                                "temp_bytes_per_dev", "peak_gb_per_dev"}
    assert e["memory"]["peak_bytes_per_dev"] >= \
        e["memory"]["args_bytes_per_dev"] > 0
    assert e["n_devices"] == 4 and e["flops_per_dev"] > 0
    assert e["roofline"]["bottleneck"] in ("compute", "memory",
                                           "collective")
    assert e["collectives"]["total_bytes"] == e["coll_bytes_per_dev"] > 0
    assert "exact" in e["correction"]


def test_dryrun_matmul_flops_are_per_rank(mesh22):
    """A (4, 8, 64) x (64, 32) product split 2 x 2 costs each rank a
    quarter of 2 * 4 * 8 * 64 * 32 (the global count would be 4x)."""
    x = distribute_tensor(torch.empty(4, 8, 64, device="meta"), mesh22,
                          [Shard(0), Replicate()])
    w = distribute_tensor(torch.empty(64, 32, device="meta"), mesh22,
                          [Replicate(), Shard(1)])
    with dryrun.StepMeter() as meter:
        x @ w
    assert meter.flops == {"float32": 2 * 4 * 8 * 64 * 32 / 4}
    # the local product, and at most a copy of the local x beside it
    assert 2 * 8 * 16 * 4 <= meter.peak <= (2 * 8 * 16 + 2 * 8 * 64) * 4


def test_dryrun_skips_and_full_config_cell():
    """A skipped cell; one full-size cell (yi_9b decode at 32k, 48
    layers) on the fake 16 x 16 mesh within a few seconds."""
    with mesh_mod.fake_group(256):
        m = mesh_mod.make_production_mesh(device="cpu")
        rep = {}
        assert dryrun.run_cell("yi_9b", "long_500k", m, report=rep) == {
            "status": "skipped", "reason": "full attention — skip"}
        e = dryrun.run_cell("yi_9b", "decode_32k", m, report=rep)
    assert e["status"] == "ok", e.get("trace")
    assert e["n_devices"] == 256 and e["run_s"] < 60
    # every rank holds its 1/256 of the bf16 KV cache at least
    cache = 2 * 48 * 128 * 32768 * 4 * 128 * 2 / 256
    assert e["memory"]["args_bytes_per_dev"] > cache
    assert e["memory"]["peak_gb_per_dev"] < 80


def test_dryrun_cli_writes_a_report(tmp_path):
    out = tmp_path / "r.json"
    assert dryrun.main(["--arch", "xlstm_125m", "--shape", "long_500k",
                        "--device", "cpu", "--out", str(out)]) == 0
    import json
    rep = json.load(open(out))
    assert list(rep) == ["xlstm_125m/long_500k/16x16"]
    assert rep["xlstm_125m/long_500k/16x16"]["status"] == "ok"
    assert os.path.getsize(out) > 0
