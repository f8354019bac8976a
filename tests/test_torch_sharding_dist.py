"""The port's 2-D (data x model) sharding on four gloo ranks against the
JAX reference on one device, on the CPU.

Four processes (``repro_torch.launch.mesh``) form a 2 x 2 ``("data",
"model")`` device mesh; parameters and AdamW moments are ``DTensor``s at
``registry.param_pspecs``'s placements and the batch is split over
``data``.  The reference runs in this process on its single CPU device:
its jitted single-device step is its own oracle for the sharded step
(``tests/test_sharding.py``), whose 2 x 2 pjit needs four host devices.

Tolerances: the sharded train step's loss within 2e-3 and every
parameter within 1e-2 of the reference's, the reference's own bounds for
its 2 x 2 step (float32 here, so the gaps measured are far smaller and
are printed); the expert-parallel MoE forward within 1e-4 of the
reference's unsharded forward; a checkpoint restored onto another mesh
exactly equal to what was saved; each other family's sharded step
against the port's unsharded one (loss within 1e-5, grad norm within
1e-4 relative, parameters within 0.5 lr); ``launch.train --mesh 2,2`` in
the
configs' bfloat16: its first loss within 2e-3 of ``--mesh 1``'s, the
next within 1e-2, the bound of ``--mesh 2`` against ``--mesh 1`` in
tests/test_torch_train_dist.py (the shards' bfloat16 matmuls round
differently from the whole model's, and the steps carry that on).
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_reduced
from repro.models import registry as ref_registry
from repro.train import checkpoint as ref_ckpt
from repro.train import loop as ref_loop
from repro.train.optimizer import OptConfig as RefOptConfig
from repro_torch.launch.mesh import serve_store

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
LOSS_TOL, PARAM_TOL = 2e-3, 1e-2       # the reference's 2 x 2 bounds
MOE_TOL = 1e-4
BF16_STEPS_TOL = 1e-2                  # tests/test_torch_train_dist.py

PRELUDE = """
import dataclasses, os
import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor import distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch import convert
from repro_torch.configs import get_reduced
from repro_torch.launch import mesh
from repro_torch.models import registry
from repro_torch.train import checkpoint, fault, loop, optimizer
R, W = int(os.environ["RANK"]), int(os.environ["WORLD"])
OUT = os.environ["OUT"]
torch.set_num_threads(1)
"""


def ranks_report(procs, out, tail=1500) -> str:
    """Every rank's return code and the tail of its log."""
    parts = []
    for r, p in enumerate(procs):
        with open(os.path.join(out, f"rank{r}.log")) as f:
            parts.append(f"--- rank {r}: returncode {p.returncode} ---\n"
                         + f.read()[-tail:])
    return "\n".join(parts)


def run_ranks(body: str, out, world=WORLD, timeout=300):
    """Run ``body`` on ``world`` gloo ranks (inside ``mesh.process_group``
    as ``g``); each rank's output goes to ``out/rank<r>.log`` and its
    results to ``out/rank<r>.npz``."""
    code = PRELUDE + "with mesh.process_group('cpu', W, R, " \
        "int(os.environ['PORT'])) as g:\n" \
        + textwrap.indent(textwrap.dedent(body), "    ")
    procs, logs = [], []
    with serve_store() as port:
        for r in range(world):
            env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
                       RANK=str(r), WORLD=str(world), PORT=str(port),
                       OUT=str(out), OMP_NUM_THREADS="1")
            log = open(os.path.join(out, f"rank{r}.log"), "w")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-c", code], env=env, stdout=log,
                stderr=subprocess.STDOUT, cwd=REPO))
        try:
            for p in procs:
                p.wait(timeout=timeout)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for log in logs:
                log.close()
    assert all(p.returncode == 0 for p in procs), ranks_report(procs, out)
    return [dict(np.load(os.path.join(out, f"rank{r}.npz")))
            for r in range(world)]


def _f32(arch):
    return dataclasses.replace(get_reduced(arch), dtype="float32")


def _flat(tree, prefix=""):
    """Reference pytree leaves by ``/``-joined key path."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        out[prefix + key] = np.asarray(leaf)
    return out


def test_sharded_train_step_matches_reference_single_device(tmp_path):
    """Reduced yi_9b (float32): the reference's state, written by its own
    checkpoint writer, restored onto the 2 x 2 mesh through
    ``convert.train_state_from_numpy`` and ``loop.shard_train_state``;
    two ``make_train_step`` steps against the reference's jitted
    single-device steps."""
    cfg = _f32("yi_9b")
    ocfg = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    step = jax.jit(ref_loop.make_train_step(cfg, RefOptConfig(**ocfg),
                                            use_scan=False, remat=False))
    state = ref_loop.init_train_state(cfg, jax.random.PRNGKey(0))
    ref_ckpt.save(str(tmp_path / "ref"), 0, state)
    rng = np.random.default_rng(0)
    batches = [{k: rng.integers(0, cfg.vocab, (8, 16)).astype(np.int32)
                for k in ("tokens", "labels")} for _ in range(2)]
    np.savez(tmp_path / "batches.npz", **{
        f"{i}/{k}": v for i, b in enumerate(batches) for k, v in b.items()})
    losses = []
    for b in batches:
        state, met = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(met["loss"]))
    want = _flat(state["params"])

    ranks = run_ranks(f"""
        from repro_torch.analysis.roofline import (CollectiveRecorder,
                                                   collective_bytes)
        cfg = dataclasses.replace(get_reduced("yi_9b"), dtype="float32")
        dmesh = mesh.make_mesh((2, 2), ("data", "model"), "cpu")
        tree, _ = checkpoint.load_tree(OUT + "/ref")
        state = convert.train_state_from_numpy(cfg, tree, "cpu")
        specs = registry.param_pspecs(cfg, state["params"],
                                      mesh.mesh_shape_dict(dmesh))
        state = loop.shard_train_state(state, dmesh, specs)
        step = loop.make_train_step(cfg, optimizer.OptConfig(**{ocfg!r}),
                                    use_scan=False, remat=False)
        d = np.load(OUT + "/batches.npz")
        losses = []
        with CollectiveRecorder() as rec:
            for i in range(2):
                b = {{k: distribute_tensor(
                    torch.as_tensor(d[f"{{i}}/{{k}}"]).long(), dmesh,
                    [Shard(0), Replicate()]) for k in ("tokens", "labels")}}
                state, met = step(state, b)
                losses.append(float(met["loss"]))
        wq = state["params"]["layers"][0]["attn"]["wq"]
        assert wq.placements == (Shard(0), Shard(1)), wq.placements
        coll = collective_bytes(rec.records)
        full = {{n: p.full_tensor().detach().numpy()
                for n, p in state["params"].named_parameters()}}
        np.savez(OUT + f"/rank{{R}}.npz", losses=np.asarray(losses),
                 n_coll=sum(coll["counts"].values()), **full)
    """, tmp_path)
    gaps = []
    for res in ranks:
        assert res["n_coll"] > 0
        assert np.max(np.abs(res["losses"] - losses)) < LOSS_TOL
        for name, a in want.items():
            port = name.replace("layers/", "layers.", 1).replace("/", ".")
            got = _unstacked(res, port, a.shape)
            gaps.append(float(np.max(np.abs(got - a))))
    print(f"loss gap {np.max(np.abs(ranks[0]['losses'] - losses)):.3g}, "
          f"largest parameter gap {max(gaps):.3g} (bounds {LOSS_TOL}, "
          f"{PARAM_TOL})")
    assert max(gaps) < PARAM_TOL


FAMILIES = ["xlstm_125m", "recurrentgemma_2b", "seamless_m4t_medium",
            "qwen2_moe_a27b"]


def test_every_family_sharded_step_equals_the_unsharded_port(tmp_path):
    """One ``make_train_step`` step of each other family (float32,
    reduced) on the 2 x 2 mesh against the port's unsharded step, which
    tests/test_torch_train.py holds against the reference: the sLSTM and
    RG-LRU loops per rank (``layers.batch_local``), MQA with its one
    key/value head read by each rank's query heads, the enc-dec's cross
    attention, the MoE dispatch.  Loss within 1e-5 and grad norm within
    1e-4 relative, parameters within 0.5 lr (AdamW's amplification of
    float32 noise, T3's bound in chip_smoke.py; measured up to 0.09 lr)."""
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models import registry
    from repro_torch.train import loop, optimizer
    from repro_torch.configs import get_reduced as port_reduced
    ranks = run_ranks(f"""
        from repro_torch.data.pipeline import TokenPipeline
        dmesh = mesh.make_mesh((2, 2), ("data", "model"), "cpu")
        res = {{}}
        for arch in {FAMILIES!r}:
            cfg = dataclasses.replace(get_reduced(arch), dtype="float32")
            state = loop.init_train_state(cfg, 0, "cpu")
            specs = registry.param_pspecs(cfg, state["params"],
                                          mesh.mesh_shape_dict(dmesh))
            state = loop.shard_train_state(state, dmesh, specs)
            pipe = TokenPipeline(
                cfg.vocab, 4, 16,
                prefix=cfg.n_prefix if cfg.frontend == "vision" else 0,
                enc_len=registry.enc_len(cfg, 16)
                if cfg.family == "encdec" else 0, d_model=cfg.d_model)
            step = loop.make_train_step(cfg, optimizer.OptConfig(
                lr=1e-2, warmup_steps=1, total_steps=6))
            state, met = step(state, pipe.next(device="cpu", mesh=dmesh))
            res[arch + "/loss"] = float(met["loss"])
            res[arch + "/gnorm"] = float(met["grad_norm"])
            for n, p in state["params"].named_parameters():
                res[arch + "/" + n] = p.full_tensor().detach().numpy()
        np.savez(OUT + f"/rank{{R}}.npz", **res)
    """, tmp_path)
    for arch in FAMILIES:
        cfg = dataclasses.replace(port_reduced(arch), dtype="float32")
        state = loop.init_train_state(cfg, 0, "cpu")
        pipe = TokenPipeline(
            cfg.vocab, 4, 16,
            prefix=cfg.n_prefix if cfg.frontend == "vision" else 0,
            enc_len=registry.enc_len(cfg, 16) if cfg.family == "encdec"
            else 0, d_model=cfg.d_model)
        state, met = loop.make_train_step(cfg, optimizer.OptConfig(
            lr=1e-2, warmup_steps=1, total_steps=6))(
                state, pipe.next(device="cpu"))
        res = ranks[0]
        assert abs(res[arch + "/loss"] - float(met["loss"])) \
            <= 1e-5 * abs(float(met["loss"])), arch
        assert abs(res[arch + "/gnorm"] - float(met["grad_norm"])) \
            <= 1e-4 * float(met["grad_norm"]), arch
        gap = max(float(np.abs(res[arch + "/" + n] - p.detach().numpy()).max())
                  for n, p in state["params"].named_parameters()) / 1e-2
        print(f"{arch}: parameter gap {gap:.3g} lr")
        assert gap <= 0.5, (arch, gap)


def _unstacked(res, name, shape):
    """The port's per-layer leaves of a reference layer-stacked leaf
    (``layers/attn/wq`` -> ``layers.<i>.attn.wq``), stacked again."""
    if not name.startswith("layers."):
        return res[name]
    rest = name[len("layers."):]
    return np.stack([res[f"layers.{i}.{rest}"] for i in range(shape[0])])


def test_moe_expert_parallel_forward_matches_reference(tmp_path):
    """Reduced qwen2_moe_a27b (float32) with its experts split over
    ``model`` (expert parallelism): collectives are recorded, and the
    logits equal the reference's unsharded forward."""
    cfg = _f32("qwen2_moe_a27b")
    m = ref_registry.get_model(cfg)
    params = m.init(cfg, jax.random.PRNGKey(0))
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (4, 16)).astype(
        np.int32)
    want = np.asarray(m.forward(params, jnp.asarray(toks), cfg,
                                use_scan=False))
    np.savez(tmp_path / "params.npz", **_flat(params))
    np.save(tmp_path / "toks.npy", toks)
    ranks = run_ranks("""
        from repro_torch.analysis.roofline import (CollectiveRecorder,
                                                   collective_bytes)
        cfg = dataclasses.replace(get_reduced("qwen2_moe_a27b"),
                                  dtype="float32")
        dmesh = mesh.make_mesh((2, 2), ("data", "model"), "cpu")
        flat = dict(np.load(OUT + "/params.npz"))
        tree = {}
        for k, v in flat.items():
            node = tree
            *head, last = k.split("/")
            for part in head:
                node = node.setdefault(part, {})
            node[last] = v
        params = convert.lm_params_from_numpy(cfg, tree, "cpu")
        specs = registry.param_pspecs(cfg, params,
                                      mesh.mesh_shape_dict(dmesh))
        params = registry.distribute_params(params, dmesh, specs)
        we = params["layers"][0]["moe"]["we_gate"]
        assert we.placements == (Shard(1), Shard(0)), we.placements
        toks = distribute_tensor(torch.as_tensor(np.load(OUT + "/toks.npy"))
                                 .long(), dmesh, [Shard(0), Replicate()])
        m = registry.get_model(cfg)
        with torch.no_grad(), implicit_replication(), \\
                CollectiveRecorder() as rec:
            out = m.forward(params, toks, cfg, use_scan=False)
        coll = collective_bytes(rec.records)
        np.savez(OUT + f"/rank{R}.npz", out=out.full_tensor().numpy(),
                 kinds=np.asarray(sorted(coll["counts"])),
                 n=sum(coll["counts"].values()))
    """, tmp_path)
    for res in ranks:
        assert res["n"] > 0 and "all-gather" in res["kinds"]
        gap = float(np.max(np.abs(res["out"] - want)))
        assert gap < MOE_TOL, gap
    print(f"MoE forward gap {gap:.3g} (bound {MOE_TOL}); collectives "
          f"{list(ranks[0]['kinds'])}")


def test_elastic_restore_onto_a_smaller_mesh(tmp_path):
    """A train state sharded on a 4 x 1 mesh (data only) is saved whole;
    ``fault.elastic_restore`` lays it out on a 1 x 2 mesh of two ranks
    and on a 2 x 2 mesh of four, equal to what was saved (the reference
    restores a 4-device checkpoint onto 2 devices,
    ``tests/test_checkpoint.py``; a reference checkpoint onto 2 x 2 is
    the first test here)."""
    body_save = """
        cfg = dataclasses.replace(get_reduced("yi_9b"), dtype="float32")
        dmesh = mesh.make_mesh((4, 1), ("data", "model"), "cpu")
        state = loop.init_train_state(cfg, 0, "cpu")
        specs = registry.param_pspecs(cfg, state["params"],
                                      mesh.mesh_shape_dict(dmesh))
        state = loop.shard_train_state(state, dmesh, specs)
        state, _ = loop.make_train_step(cfg, optimizer.OptConfig(lr=1e-2))(
            state, {k: distribute_tensor(
                torch.arange(64).reshape(4, 16) % cfg.vocab, dmesh,
                [Shard(0), Replicate()]) for k in ("tokens", "labels")})
        checkpoint.save(OUT + "/ck", 1, state)
        np.savez(OUT + f"/rank{R}.npz", **{
            n: p.full_tensor().detach().numpy()
            for n, p in state["params"].named_parameters()})
    """
    saved = run_ranks(body_save, tmp_path)[0]
    assert sorted(os.listdir(tmp_path / "ck")) == ["step_00000001"]
    body_restore = """
        cfg = dataclasses.replace(get_reduced("yi_9b"), dtype="float32")
        shape = dict(zip(("data", "model"), SHAPE))
        dmesh = mesh.make_mesh(SHAPE, ("data", "model"), "cpu")
        from repro_torch.models import layers as L
        p = L.Params(registry.family_module(cfg).param_tree(cfg,
                                                            L.ShapeInit()))
        p.requires_grad_(True)
        like = {"params": p, "opt": optimizer.init_opt_state(p),
                "step": torch.zeros((), dtype=torch.int32, device="meta")}
        specs = registry.param_pspecs(cfg, like["params"], shape)
        got, man = fault.elastic_restore(OUT + "/ck", like, dmesh,
                                         loop.state_pspecs(specs))
        wq = got["params"]["layers"][0]["attn"]["wq"]
        assert isinstance(wq, DTensor) and wq.device_mesh.size() == W
        assert wq.placements == tuple(registry.placements(
            specs["layers"][0]["attn"]["wq"], dmesh))
        assert got["params"]["embed"].requires_grad
        np.savez(OUT + f"/rank{R}.npz", step=int(got["step"]), **{
            n: p.full_tensor().detach().numpy()
            for n, p in got["params"].named_parameters()})
    """
    for shape, world in (((1, 2), 2), ((2, 2), 4)):
        back = run_ranks(f"SHAPE = {shape}\n"
                         + textwrap.dedent(body_restore), tmp_path,
                         world=world)
        for res in back:
            assert int(res["step"]) == 1
            for name, a in saved.items():
                np.testing.assert_array_equal(res[name], a)


def _losses(out: str) -> list:
    return [float(ln.split("loss=")[1].split()[0])
            for ln in out.splitlines() if ln.startswith("step")]


def test_train_cli_mesh_two_by_two_equals_one(tmp_path):
    """``launch.train --mesh 2,2``: four gloo ranks on a data x model
    mesh, with a checkpoint, give ``--mesh 1``'s losses."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    base = [sys.executable, "-m", "repro_torch.launch.train", "--device",
            "cpu", "--arch", "yi_9b", "--reduced", "--steps", "3",
            "--batch", "4", "--seq", "16", "--log-every", "1"]
    outs = []
    for extra in (["--mesh", "1"], ["--mesh", "2,2", "--ckpt-dir",
                                    str(tmp_path)]):
        r = subprocess.run(base + extra, capture_output=True, text=True,
                           timeout=600, env=env, cwd=REPO)
        assert r.returncode == 0, r.stderr[-3000:]
        assert "done: 3 steps" in r.stdout
        outs.append(r.stdout)
    one, mesh = _losses(outs[0]), _losses(outs[1])
    assert len(one) == len(mesh) == 3
    print(f"--mesh 2,2 against --mesh 1: loss gaps "
          f"{[abs(a - b) for a, b in zip(one, mesh)]}")
    assert abs(mesh[0] - one[0]) < LOSS_TOL
    np.testing.assert_allclose(mesh, one, atol=BF16_STEPS_TOL)
    assert os.path.isdir(tmp_path / "step_00000003")
