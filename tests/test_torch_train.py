"""The port's training path against the JAX reference on the CPU.

The same numpy-seeded inputs go through ``repro`` and ``repro_torch``:
the token stream and ``TokenPipeline`` (bytes equal), the AdamW schedule
and update, every reduced architecture's loss and gradients with the
reference's weights carried across (``convert.lm_params_from_numpy``),
whole ``make_train_step`` steps, checkpoints (the reference's layout; a
reference checkpoint restored through ``convert.train_state_from_numpy``),
the fail-and-rescale drill and the ``launch.train`` CLI.

Tolerances (float32): optimizer leaves within 1e-6 relative on
identical gradients; an architecture's loss within 1e-5 and each
gradient leaf within 1e-4 of that leaf's max-abs (or of 1e-4 of the
model's largest gradient element, for a leaf whose gradient is float32
noise below it: the sLSTM input-gate bias, whose gradient is 0 but
comes out near 1e-9 in both packages); a train step's loss within 1e-5
relative, its grad norm within 1e-4 relative, and every parameter
element within 5 % of one step's size (0.05 lr) of the reference's.
AdamW moves an element by about lr whatever the size of its gradient,
so an element whose gradient is small for its leaf (a rare token's
embedding row, a moment near cancellation) carries the packages' float32
rounding differences into its step at full weight: the largest gap
measured over three steps is 0.026 lr (xLSTM), 4e-4 lr or less for the
dense archs.  The port's own remat/no-remat and drill checks are exact.
"""
import dataclasses
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, get_reduced
from repro.data import pipeline as ref_pipeline
from repro.data import synthetic as ref_synthetic
from repro.models import moe as ref_moe
from repro.models import registry as ref_registry
from repro.train import checkpoint as ref_ckpt
from repro.train import loop as ref_loop
from repro.train import optimizer as ref_opt
from repro_torch import convert
from repro_torch.configs import get_reduced as port_reduced
from repro_torch.data import pipeline, synthetic
from repro_torch.launch import train as train_cli
from repro_torch.models import layers as L
from repro_torch.models import moe, registry
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import fault, loop
from repro_torch.train import optimizer as opt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPT_REL = 1e-6
LOSS_TOL, GRAD_REL = 1e-5, 1e-4
STEP_FRAC = 0.05                 # of lr, per parameter element
B, S = 2, 16


def cfgs(arch):
    """(reference, port) reduced configs computing in float32."""
    return (dataclasses.replace(get_reduced(arch), dtype="float32"),
            dataclasses.replace(port_reduced(arch), dtype="float32"))


def make_pipe(cfg, batch=B, seq=S, module=pipeline):
    return module.TokenPipeline(
        vocab=cfg.vocab, batch=batch, seq=seq,
        prefix=cfg.n_prefix if cfg.frontend == "vision" else 0,
        enc_len=ref_registry.enc_len(cfg, seq) if cfg.family == "encdec"
        else 0, d_model=cfg.d_model)


def torch_batch(b):
    return {k: torch.as_tensor(v).long() if v.dtype == np.int32
            else torch.as_tensor(v) for k, v in b.items()}


def fwd_kw(cfg, remat, use_scan=True):
    kw = {"remat": remat}
    if cfg.family in ("dense", "moe", "encdec"):
        kw["use_scan"] = use_scan
    return kw


@functools.lru_cache(maxsize=None)
def reference_params(arch):
    cfg = get_reduced(arch)
    params = ref_registry.get_model(cfg).init(cfg, jax.random.PRNGKey(0))
    return params, jax.tree.map(np.asarray, params)


def named(tree_np) -> dict:
    """A reference pytree (stacked layers) by the port's parameter names."""
    return {k: np.asarray(v)
            for k, v in convert._flatten(convert._unstack(tree_np)).items()}


def rel_gap(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def assert_params_match(params, ref_params, lr):
    want = named(jax.tree.map(np.asarray, ref_params))
    for n, p in params.named_parameters():
        gap = float(np.max(np.abs(p.detach().numpy() - want[n])))
        assert gap <= STEP_FRAC * lr, (n, gap / lr)


def port_params(arch, cfg):
    params = convert.lm_params_from_numpy(cfg, reference_params(arch)[1],
                                          "cpu")
    return params.requires_grad_(True)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vocab,batch,seq,step,seed", [
    (256, 2, 16, 0, 0), (50304, 4, 33, 7, 3), (17, 3, 5, 2, 11)])
def test_token_batch_equals_reference(vocab, batch, seq, step, seed):
    got = synthetic.token_batch(vocab, batch, seq, step, seed)
    want = ref_synthetic.token_batch(vocab, batch, seq, step, seed)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert got[k].tobytes() == want[k].tobytes()


@pytest.mark.parametrize("arch", ["llava_next_34b", "seamless_m4t_medium",
                                  "yi_9b"])
def test_pipeline_equals_reference_and_resumes(arch):
    cfg = get_reduced(arch)
    ours, ref = make_pipe(cfg), make_pipe(cfg, module=ref_pipeline)
    for _ in range(3):
        a, b = ours.next(), ref.next()
        assert a.keys() == b.keys()
        for k in b:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()
    assert ours.state() == ref.state() == {"seed": 0, "step": 3}
    resumed = make_pipe(cfg)
    resumed.load_state(ours.state())
    x, y = resumed.next(), ours.next()
    for k in x:
        assert x[k].tobytes() == y[k].tobytes()


def test_pipeline_rank_rows_on_device():
    cfg = get_reduced("llava_next_34b")
    full = make_pipe(cfg, batch=4).next()
    for rank in range(2):
        part = make_pipe(cfg, batch=4).next(device="cpu", rank=rank, world=2)
        for k, v in full.items():
            assert part[k].device.type == "cpu"
            np.testing.assert_array_equal(part[k].numpy(),
                                          v[rank * 2:(rank + 1) * 2])
        assert part["tokens"].dtype == torch.int64
    with pytest.raises(ValueError, match="split evenly"):
        make_pipe(cfg, batch=3).next(device="cpu", rank=0, world=2)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

OPT_CFGS = [
    opt.OptConfig(lr=1e-2, warmup_steps=2, total_steps=6),
    opt.OptConfig(lr=3e-3, warmup_steps=1, total_steps=10, clip_norm=0.05,
                  weight_decay=0.5),
]


@pytest.mark.parametrize("ocfg", OPT_CFGS)
def test_schedule_equals_reference(ocfg):
    rcfg = ref_opt.OptConfig(**dataclasses.asdict(ocfg))
    for s in range(0, 14):
        got = float(opt.schedule(torch.tensor(s, dtype=torch.int32), ocfg))
        want = float(ref_opt.schedule(jnp.asarray(s, jnp.int32), rcfg))
        assert abs(got - want) <= OPT_REL * max(abs(want), 1e-30), (s, got,
                                                                     want)


@pytest.mark.parametrize("ocfg", OPT_CFGS)
def test_adamw_matches_reference(ocfg):
    """Five steps on identical grads: clipping (the second config clips
    every step), bias corrections and matrices-only decay."""
    rng = np.random.default_rng(0)
    tree = {"mat": rng.normal(0, 1, (6, 5)).astype(np.float32),
            "vec": rng.normal(0, 1, (5,)).astype(np.float32),
            "stack": rng.normal(0, 1, (2, 3, 4)).astype(np.float32)}
    params = L.Params({k: torch.as_tensor(v.copy()) for k, v in tree.items()})
    state = opt.init_opt_state(params)
    rparams = {k: jnp.asarray(v) for k, v in tree.items()}
    rstate = ref_opt.init_opt_state(rparams)
    rcfg = ref_opt.OptConfig(**dataclasses.asdict(ocfg))
    names = [n for n, _ in params.named_parameters()]
    for _ in range(5):
        g = {k: rng.normal(0, 0.3, v.shape).astype(np.float32)
             for k, v in tree.items()}
        params, state, m = opt.adamw_update(
            [torch.as_tensor(g[n]) for n in names], state, params, ocfg)
        rparams, rstate, rm = ref_opt.adamw_update(
            {k: jnp.asarray(v) for k, v in g.items()}, rstate, rparams, rcfg)
        assert rel_gap(m["grad_norm"].numpy(), rm["grad_norm"]) < OPT_REL
        assert rel_gap(m["lr"].numpy(), rm["lr"]) < OPT_REL
        for n, p in params.named_parameters():
            assert rel_gap(p.detach().numpy(), rparams[n]) < OPT_REL, n
        for n, p in state["m"].named_parameters():
            assert rel_gap(p.numpy(), rstate["m"][n]) < OPT_REL, n
        for n, p in state["v"].named_parameters():
            assert rel_gap(p.numpy(), rstate["v"][n]) < OPT_REL, n
    assert int(state["count"]) == int(rstate["count"]) == 5


def test_global_norm_and_clip_report_pre_clip_norm():
    params = L.Params({"x": torch.zeros(3)})
    state = opt.init_opt_state(params)
    cfg = opt.OptConfig(lr=1e-3, clip_norm=1.0, warmup_steps=1,
                        total_steps=10)
    params, _, m = opt.adamw_update([torch.tensor([1e6, 0.0, 0.0])], state,
                                    params, cfg)
    assert float(torch.max(torch.abs(params["x"]))) < 1.0
    assert float(m["grad_norm"]) > 1e5
    assert float(opt.global_norm([torch.tensor([3.0]), torch.tensor([4.0])])
                 ) == 5.0


def test_weight_decay_on_matrices_only():
    cfg = opt.OptConfig(lr=1e-2, weight_decay=1.0, warmup_steps=1,
                        total_steps=10, clip_norm=1e9)
    params = L.Params({"mat": torch.ones(2, 2), "vec": torch.ones(2)})
    state = opt.init_opt_state(params)
    zeros = [torch.zeros_like(p) for p in params.parameters()]
    params, _, _ = opt.adamw_update(zeros, state, params, cfg)
    assert float(params["mat"][0, 0]) < 1.0
    assert float(params["vec"][0]) == 1.0


def test_adamw_rejects_misaligned_grads():
    params = L.Params({"a": torch.ones(2), "b": torch.ones(2)})
    with pytest.raises(ValueError, match="gradients"):
        opt.adamw_update([torch.ones(2)], opt.init_opt_state(params), params,
                         opt.OptConfig())


# ---------------------------------------------------------------------------
# trainable parameters
# ---------------------------------------------------------------------------

def test_held_copy_never_reaches_a_trainable_graph():
    """A frozen tree reads its held bf16 copy; once trainable, ``w``/``take``
    cast the live float32 leaf (gradients flow, nothing stale), and
    ``hold`` on a trainable tree raises."""
    p = L.Params({"wq": torch.randn(4, 3), "embed": torch.randn(5, 4)})
    p.hold(torch.bfloat16)
    assert p.w("wq", torch.bfloat16) is p._held[("wq", torch.bfloat16)]
    p.requires_grad_(True)
    with torch.no_grad():
        p["wq"].mul_(2.0)                    # the held copy is now stale
    w = p.w("wq", torch.bfloat16)
    assert w.requires_grad and torch.equal(w, p["wq"].to(torch.bfloat16))
    rows = p.take("embed", torch.tensor([1, 3]), torch.bfloat16)
    (w.float().sum() + rows.float().sum()).backward()
    assert torch.equal(p["wq"].grad, torch.ones(4, 3))
    assert float(p["embed"].grad.sum()) == 8.0
    with pytest.raises(ValueError, match="trainable"):
        p.hold(torch.bfloat16)


def test_params_map_and_tree_keep_structure():
    cfg = port_reduced("xlstm_125m")
    params = registry.get_model(cfg).init(cfg, 0, "cpu")
    zeros = params.map(torch.zeros_like)
    assert [n for n, _ in zeros.named_parameters()] == \
        [n for n, _ in params.named_parameters()]
    assert not any(p.requires_grad for p in zeros.parameters())
    assert isinstance(params.tree()["blocks"], list)


@pytest.mark.parametrize("arch", ["yi_9b", "qwen2_moe_a27b",
                                  "seamless_m4t_medium", "xlstm_125m",
                                  "recurrentgemma_2b"])
def test_remat_equals_no_remat(arch):
    """Activation recomputation changes no number: equal losses and
    gradients, one family each."""
    _, cfg = cfgs(arch)
    batch = torch_batch(make_pipe(cfg).next())
    m = registry.get_model(cfg)
    out = []
    for remat in (False, True):
        params = port_params(arch, cfg)
        loss = m.loss_fn(params, batch, cfg, **fwd_kw(cfg, remat))
        loss.backward()
        out.append((loss.detach(), [p.grad for p in params.parameters()]))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert (a is None and b is None) or torch.equal(a, b)


# ---------------------------------------------------------------------------
# loss and gradients of every reduced arch against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    rcfg, cfg = cfgs(arch)
    b = make_pipe(cfg).next()
    rm = ref_registry.get_model(rcfg)
    rbatch = {k: jnp.asarray(v) for k, v in b.items()}
    kw = fwd_kw(cfg, remat=True)
    rloss, rgrads = jax.jit(jax.value_and_grad(
        lambda p: rm.loss_fn(p, rbatch, rcfg, **kw)))(reference_params(arch)[0])
    params = port_params(arch, cfg)
    loss = registry.get_model(cfg).loss_fn(params, torch_batch(b), cfg, **kw)
    loss.backward()
    assert abs(float(loss.detach()) - float(rloss)) < LOSS_TOL, (
        float(loss.detach()), float(rloss))
    want = named(jax.tree.map(np.asarray, rgrads))
    # a leaf the loss does not reach (sLSTM blocks' w_q, w_k) has no
    # .grad; jax.grad gives it zeros
    got = {n: p.grad if p.grad is not None else torch.zeros_like(p)
           for n, p in params.named_parameters()}
    assert got.keys() == want.keys()
    floor = GRAD_REL * max(float(np.max(np.abs(w))) for w in want.values())
    for n, g in got.items():
        gap = float(np.max(np.abs(g.numpy() - want[n])))
        scale = max(float(np.max(np.abs(want[n]))), floor)
        assert gap < GRAD_REL * scale, (n, gap / scale)


def test_moe_dropped_tokens_get_zero_gradient_as_in_reference():
    """Capacity 8 of 32 assignments per expert: dropped tokens contribute
    nothing, and the input gradient equals the reference's."""
    cfg = dataclasses.replace(port_reduced("qwen2_moe_a27b"),
                              dtype="float32", capacity_factor=0.25)
    rcfg = dataclasses.replace(get_reduced("qwen2_moe_a27b"),
                               dtype="float32", capacity_factor=0.25)
    lp = reference_params("qwen2_moe_a27b")[1]["layers"]["moe"]
    layer0 = jax.tree.map(lambda a: a[0], lp)
    x = np.random.default_rng(1).normal(0, 1, (2, 16, cfg.d_model)
                                        ).astype(np.float32)
    assert moe.capacity(cfg, 32) == 8
    rg = jax.grad(lambda x_: jnp.sum(ref_moe.moe_block(
        layer0, x_, rcfg) ** 2))(jnp.asarray(x))
    p = L.Params({k: torch.tensor(np.asarray(v)) if not isinstance(v, dict)
                  else {kk: torch.tensor(np.asarray(vv))
                        for kk, vv in v.items()}
                  for k, v in layer0.items()})
    xt = torch.as_tensor(x).requires_grad_(True)
    torch.sum(moe.moe_block(p, xt, cfg) ** 2).backward()
    assert rel_gap(xt.grad.numpy(), np.asarray(rg)) < GRAD_REL


# ---------------------------------------------------------------------------
# whole train steps
# ---------------------------------------------------------------------------

STEP_CASES = [("yi_9b", 1, False), ("yi_9b", 1, True), ("yi_9b", 2, False),
              ("yi_9b", 2, True), ("qwen2_moe_a27b", 2, True),
              ("seamless_m4t_medium", 1, True), ("xlstm_125m", 2, False)]


@pytest.mark.parametrize("arch,accum,remat", STEP_CASES)
def test_train_steps_match_reference(arch, accum, remat):
    rcfg, cfg = cfgs(arch)
    ocfg = opt.OptConfig(lr=1e-2, warmup_steps=1, total_steps=6)
    rstep = jax.jit(ref_loop.make_train_step(
        rcfg, ref_opt.OptConfig(**dataclasses.asdict(ocfg)),
        use_scan=True, remat=remat, accum=accum))
    rparams = reference_params(arch)[0]
    rstate = {"params": rparams, "opt": ref_opt.init_opt_state(rparams),
              "step": jnp.zeros((), jnp.int32)}
    step = loop.make_train_step(cfg, ocfg, use_scan=True, remat=remat,
                                accum=accum)
    params = port_params(arch, cfg)
    state = {"params": params, "opt": opt.init_opt_state(params),
             "step": torch.zeros((), dtype=torch.int32)}
    pipe = make_pipe(cfg, batch=4)
    for _ in range(3):
        b = pipe.next()
        rstate, rmet = rstep(rstate, {k: jnp.asarray(v) for k, v in b.items()})
        state, met = step(state, torch_batch(b))
        assert rel_gap(met["loss"].numpy(), rmet["loss"]) < LOSS_TOL
        assert rel_gap(met["grad_norm"].numpy(), rmet["grad_norm"]) < GRAD_REL
        assert float(met["lr"]) == pytest.approx(float(rmet["lr"]), rel=1e-6)
    assert int(state["step"]) == int(rstate["step"]) == 3
    assert_params_match(state["params"], rstate["params"], ocfg.lr)


def test_train_step_refuses_frozen_params():
    _, cfg = cfgs("yi_9b")
    state = loop.init_train_state(cfg, 0, "cpu")
    state["params"].requires_grad_(False)
    step = loop.make_train_step(cfg, opt.OptConfig())
    with pytest.raises(ValueError, match="frozen"):
        step(state, torch_batch(make_pipe(cfg).next()))


def test_init_train_state_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        loop.init_train_state(port_reduced("yi_9b"))


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _tree():
    return {"a": torch.arange(12.0).reshape(3, 4),
            "nested": {"b": torch.ones((2, 2), dtype=torch.bfloat16),
                       "c": torch.tensor(3, dtype=torch.int32)},
            "lst": [torch.zeros(5), torch.ones(5)]}


def _ref_tree():
    return {"a": jnp.arange(12.0, dtype=jnp.float32).reshape(3, 4),
            "nested": {"b": jnp.ones((2, 2), jnp.bfloat16),
                       "c": jnp.asarray(3, jnp.int32)},
            "lst": [jnp.zeros(5, jnp.float32), jnp.ones(5, jnp.float32)]}


def test_save_restore_roundtrip_with_bf16_leaf(tmp_path):
    t = _tree()
    ckpt.save(str(tmp_path), 7, t, extra={"pipeline": {"seed": 0, "step": 9}})
    like = {"a": torch.empty(3, 4, device="meta"),
            "nested": {"b": torch.empty(2, 2, device="meta"),
                       "c": torch.empty((), device="meta")},
            "lst": [torch.empty(5, device="meta")] * 2}
    got, manifest = ckpt.restore(str(tmp_path), like)
    assert manifest["step"] == 7 and manifest["extra"]["pipeline"]["step"] == 9
    assert manifest["dtypes"] == {"nested/b": "bfloat16"}
    assert got["nested"]["b"].dtype == torch.bfloat16
    assert got["nested"]["c"].dtype == torch.int32
    for a, b in ((t["a"], got["a"]), (t["nested"]["b"], got["nested"]["b"]),
                 (t["nested"]["c"], got["nested"]["c"]),
                 (t["lst"][1], got["lst"][1])):
        assert torch.equal(a, b)


def test_layout_equals_reference(tmp_path):
    """The same tree saved by both packages: equal keys, manifests and
    array bytes; each package restores the other's file."""
    ckpt.save(str(tmp_path / "port"), 3, _tree(), extra={"x": 1})
    ref_ckpt.save(str(tmp_path / "ref"), 3, _ref_tree(), extra={"x": 1})
    dirs = [tmp_path / d / "step_00000003" for d in ("port", "ref")]
    (pa, pm), (ra, rm) = [
        (np.load(d / "arrays.npz"), __import__("json").load(
            open(d / "manifest.json"))) for d in dirs]
    assert sorted(pa.files) == sorted(ra.files)
    for k in ra.files:
        assert pa[k].dtype == ra[k].dtype and pa[k].tobytes() == ra[k].tobytes()
    assert pm == rm
    got, _ = ckpt.restore(str(tmp_path / "ref"), _tree())
    assert torch.equal(got["nested"]["b"], _tree()["nested"]["b"])
    back, _ = ref_ckpt.restore(str(tmp_path / "port"),
                               jax.eval_shape(_ref_tree))
    assert np.array_equal(np.asarray(back["a"]), np.asarray(_ref_tree()["a"]))


def test_latest_step_and_atomicity(tmp_path):
    for s in (1, 5, 3):
        ckpt.save(str(tmp_path), s, _tree())
    assert ckpt.latest_step(str(tmp_path)) == 5
    assert not [d for d in os.listdir(tmp_path) if d.startswith(".tmp")]
    assert ckpt.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "none"), _tree())


def test_async_save_snapshots_before_returning(tmp_path):
    t = {"w": torch.zeros(4)}
    th = ckpt.save_async(str(tmp_path), 2, t)
    t["w"].add_(1.0)                         # the next step, in place
    th.join(timeout=30)
    assert not th.is_alive()
    got, _ = ckpt.restore(str(tmp_path), {"w": torch.empty(4)})
    assert torch.equal(got["w"], torch.zeros(4))


def test_shape_mismatch_raises(tmp_path):
    ckpt.save(str(tmp_path), 1, {"a": torch.zeros(2, 2)})
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.restore(str(tmp_path), {"a": torch.zeros(3, 3)})


def test_train_state_roundtrip_keys_and_trainability(tmp_path):
    _, cfg = cfgs("xlstm_125m")
    state = loop.init_train_state(cfg, 0, "cpu")
    ckpt.save(str(tmp_path), 0, state)
    got, _ = ckpt.restore(str(tmp_path), state)
    assert all(p.requires_grad for p in got["params"].parameters())
    assert not any(p.requires_grad for p in got["opt"]["m"].parameters())
    keys = np.load(tmp_path / "step_00000000" / "arrays.npz").files
    assert "params/blocks/0/w_up" in keys and "opt/v/head" in keys
    assert "opt/count" in keys and "step" in keys
    for a, b in zip(state["params"].parameters(), got["params"].parameters()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["yi_9b", "seamless_m4t_medium",
                                  "recurrentgemma_2b"])
def test_reference_checkpoint_restores_and_next_step_matches(arch, tmp_path):
    """Two reference steps, saved by ``repro.train.checkpoint``; the port
    loads the file, converts it, and both take the third step."""
    rcfg, cfg = cfgs(arch)
    ocfg = opt.OptConfig(lr=1e-2, warmup_steps=1, total_steps=6)
    rstep = jax.jit(ref_loop.make_train_step(
        rcfg, ref_opt.OptConfig(**dataclasses.asdict(ocfg)), remat=False))
    rparams = reference_params(arch)[0]
    rstate = {"params": rparams, "opt": ref_opt.init_opt_state(rparams),
              "step": jnp.zeros((), jnp.int32)}
    pipe = make_pipe(cfg)
    for _ in range(2):
        rstate, _ = rstep(rstate, {k: jnp.asarray(v)
                                   for k, v in pipe.next().items()})
    ref_ckpt.save(str(tmp_path), 2, rstate, extra={"pipeline": pipe.state()})
    tree, manifest = ckpt.load_tree(str(tmp_path))
    state = convert.train_state_from_numpy(cfg, tree, "cpu")
    assert int(state["step"]) == 2 and int(state["opt"]["count"]) == 2
    resumed = make_pipe(cfg)
    resumed.load_state(manifest["extra"]["pipeline"])
    b = resumed.next()
    rstate, rmet = rstep(rstate, {k: jnp.asarray(v) for k, v in b.items()})
    state, met = loop.make_train_step(cfg, ocfg, remat=False)(state,
                                                              torch_batch(b))
    assert abs(float(met["loss"]) - float(rmet["loss"])) < LOSS_TOL
    assert_params_match(state["params"], rstate["params"], ocfg.lr)


# ---------------------------------------------------------------------------
# fault drill and the CLI
# ---------------------------------------------------------------------------

def test_fail_and_rescale_drill_is_bit_exact(tmp_path):
    _, cfg = cfgs("recurrentgemma_2b")
    ocfg = opt.OptConfig(lr=5e-3, warmup_steps=1, total_steps=8)
    step = loop.make_train_step(cfg, ocfg)
    pipe = make_pipe(cfg)
    batches = [torch_batch(pipe.next()) for _ in range(5)]
    plain = loop.init_train_state(cfg, 0, "cpu")
    want = []
    for b in batches:
        plain, met = step(plain, b)
        want.append(float(met["loss"]))
    state, got = fault.drill_fail_and_rescale(
        step, loop.init_train_state(cfg, 0, "cpu"), batches, str(tmp_path),
        fail_after=2, device="cpu")
    assert got == want
    assert ckpt.latest_step(str(tmp_path)) == 5
    for a, b in zip(plain["params"].parameters(),
                    state["params"].parameters()):
        assert torch.equal(a, b)
    restored, _ = fault.elastic_restore(str(tmp_path), state, device="cpu",
                                        step=3)
    assert int(restored["step"]) == 3


def _cli(argv, capsys):
    train_cli.main(argv)
    return capsys.readouterr().out


def test_train_cli_resume_continues_the_stream(tmp_path, capsys):
    """Six steps with a checkpoint every three; after losing the last
    checkpoint, ``--resume`` starts from step 3 and prints the same
    losses for steps 4-6 (the pipeline cursor came back with it)."""
    base = ["--device", "cpu", "--arch", "xlstm_125m", "--reduced",
            "--batch", "2", "--seq", "16", "--log-every", "1",
            "--ckpt-dir", str(tmp_path), "--steps", "6"]
    first = _cli(base + ["--ckpt-every", "3"], capsys)
    assert "done: 6 steps" in first
    import shutil
    shutil.rmtree(tmp_path / "step_00000006")
    second = _cli(base + ["--resume"], capsys)
    assert second.splitlines()[0] == "resumed from step 3"

    def losses(out):
        return [ln.split("(")[0] for ln in out.splitlines()
                if ln.startswith("step")]
    assert losses(second) == losses(first)[3:]
    _, manifest = ckpt.load_tree(str(tmp_path))
    assert manifest["extra"]["pipeline"] == {"seed": 0, "step": 6}


def test_train_cli_runs_as_a_module():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--arch", "recurrentgemma_2b", "--reduced", "--steps", "4",
         "--batch", "2", "--seq", "16", "--log-every", "2"],
        capture_output=True, text=True, timeout=600, env=env, cwd=REPO)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "done: 4 steps" in r.stdout


def test_train_cli_defaults_to_the_card_and_refuses_a_model_axis(capsys):
    """The card by default; a model axis is taken now (``--mesh D,M``,
    tests/test_torch_sharding_dist.py), and a mesh of three axes or an
    empty axis is refused."""
    assert train_cli.build_parser().parse_args(["--arch", "x"]).device \
        == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="cuda"):
            train_cli.main(["--arch", "yi_9b", "--reduced", "--steps", "1"])
    for bad in ("4,2,1", "0,2"):
        with pytest.raises(SystemExit, match="data,model"):
            train_cli.main(["--device", "cpu", "--arch", "yi_9b", "--reduced",
                            "--mesh", bad])
    assert train_cli.mesh_dims("4,1") == (4, 1)
    assert train_cli.mesh_dims("4") == (4,)


def test_make_train_step_freezes_the_heap_made_before_it():
    """Every object alive when the step is made leaves the cyclic
    collector's reach, so a full collection during training walks only
    what the steps made; the step still trains."""
    import gc
    _, cfg = cfgs("yi_9b")
    state = loop.init_train_state(cfg, 0, "cpu")
    gc.unfreeze()
    try:
        step = loop.make_train_step(cfg, opt.OptConfig())
        assert gc.get_freeze_count() > 0
        tokens = torch.randint(0, cfg.vocab, (2, 9))
        state, met = step(state, {"tokens": tokens[:, :-1],
                                  "labels": tokens[:, 1:]})
        assert torch.isfinite(met["loss"]) and state["step"] == 1
    finally:
        gc.unfreeze()
