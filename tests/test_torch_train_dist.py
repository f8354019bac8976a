"""The port's collectives on ``torch.distributed`` against the reference's
``shard_map`` on four host devices, on the CPU.

Four gloo ranks (one process each, ``repro_torch.launch.mesh``) run
``compressed_psum``, ``compress_tree_psum``, ``make_dp_compressed_step``
and ``make_spmd_admm``; the reference runs the same numpy inputs on a
4-device mesh in a subprocess (the ``subproc`` fixture).  Tolerances:
quantized sums within one quantum (scale / qmax) of the reference's per
element, and equal to the integer sum of every rank's own codes; the
compressed DP step's first loss within 1e-5 relative and the next two
within 1e-3 (a gradient element whose 8-bit code rounds the other way
between the packages moves by a whole quantum, max|g| / 127, and AdamW
turns that into up to a full step for it; measured 1.6e-4); SPMD ADMM
(float64) within 1e-10.  ``make_train_step`` over two ranks equals one
rank on the whole batch in float32 (losses and grad norms within 1e-5
relative, parameters within 0.05 lr); ``launch.train --mesh 2`` trains
data parallel in the configs' bfloat16, where the halves' matmuls round
differently from the whole batch's: losses within 1e-2, grad norms
within 2 % of ``--mesh 1``'s.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from repro_torch.launch.mesh import serve_store

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4

PRELUDE = """
import os
import numpy as np
import torch
from repro_torch.launch import mesh
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
    as ``g``); each rank's stdout and stderr go to files under ``out``."""
    code = PRELUDE + "with mesh.process_group('cpu', W, R, int(os.environ['PORT'])) as g:\n" \
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


def grads_input(n=128, seed=0):
    return np.random.default_rng(seed).normal(0, 1, (WORLD, n)
                                              ).astype(np.float32)


@pytest.mark.parametrize("bits", [8, 16])
def test_compressed_psum_matches_reference(bits, subproc, tmp_path):
    g = grads_input()
    np.save(tmp_path / "g.npy", g)
    subproc(f"""
        import numpy as np, jax, jax.numpy as jnp
        from jax.sharding import PartitionSpec as P
        from jax.experimental.shard_map import shard_map
        from repro.core import secure_agg
        mesh = jax.make_mesh((4,), ("data",))
        g = np.load(r"{tmp_path}/g.npy")
        f = shard_map(lambda x: secure_agg.compressed_psum(
                          x[0], "data", bits={bits})[None],
                      mesh=mesh, in_specs=P("data", None),
                      out_specs=P("data", None))
        with mesh:
            np.save(r"{tmp_path}/ref.npy", np.asarray(f(jnp.asarray(g))))
    """)
    ranks = run_ranks(f"""
        from repro_torch.core import secure_agg
        g_all = torch.as_tensor(np.load(OUT + "/g.npy"))
        out = secure_agg.compressed_psum(g_all[R].clone(), g, bits={bits})
        # every rank's own codes under the shared scale, summed as ints
        scale = g_all.abs().max().clamp(min=1e-30)
        qm = float(2 ** ({bits} - 1) - 1)
        codes = torch.round(g_all / scale * qm).to(torch.int64).sum(0)
        np.savez(OUT + f"/rank{{R}}.npz", out=out.numpy(),
                 exact=(codes.to(torch.float32) * (scale / qm)).numpy(),
                 quantum=np.float32(scale / qm))
    """, tmp_path)
    ref = np.load(tmp_path / "ref.npy")
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(res["out"], ranks[0]["out"])
        # exact-sum property: dequantize(sum(q)) == sum of the codes
        np.testing.assert_array_equal(res["out"], res["exact"])
        assert np.max(np.abs(res["out"] - ref[r])) <= res["quantum"], r
        assert np.max(np.abs(res["out"] - g.sum(0))) <= \
            WORLD * res["quantum"] / 2 * (1 + 1e-5)


def test_compress_tree_psum_with_error_feedback_matches_reference(
        subproc, tmp_path):
    """Two rounds over two leaves; the residuals carry into round two."""
    rng = np.random.default_rng(3)
    a = rng.normal(0, 1, (2, WORLD, 6, 5)).astype(np.float32)
    b = rng.normal(0, 0.01, (2, WORLD, 7)).astype(np.float32)
    np.savez(tmp_path / "in.npz", a=a, b=b)
    subproc(f"""
        import numpy as np, jax, jax.numpy as jnp
        from jax.sharding import PartitionSpec as P
        from jax.experimental.shard_map import shard_map
        from repro.core import secure_agg
        d = np.load(r"{tmp_path}/in.npz")
        cfg = secure_agg.CompressionConfig(bits=8)
        mesh = jax.make_mesh((4,), ("data",))

        def two_rounds(a, b):
            grads = {{"a": a[0], "b": b[0]}}
            red1, res = secure_agg.compress_tree_psum(grads, "data", cfg)
            grads = {{"a": a[1], "b": b[1]}}
            red2, res = secure_agg.compress_tree_psum(grads, "data", cfg,
                                                      res)
            return (red1["a"][None], red1["b"][None], red2["a"][None],
                    red2["b"][None], res["a"][None], res["b"][None])
        f = shard_map(lambda a, b: two_rounds(a[0], b[0]), mesh=mesh,
                      in_specs=(P("data"), P("data")),
                      out_specs=(P("data"),) * 6, check_rep=False)
        a = jnp.asarray(d["a"]).transpose(1, 0, 2, 3)
        b = jnp.asarray(d["b"]).transpose(1, 0, 2)
        with mesh:
            outs = [np.asarray(o) for o in f(a, b)]
        np.savez(r"{tmp_path}/ref.npz", **{{f"o{{i}}": o
                                           for i, o in enumerate(outs)}})
    """)
    ranks = run_ranks("""
        from repro_torch.core import secure_agg
        d = np.load(OUT + "/in.npz")
        cfg = secure_agg.CompressionConfig(bits=8)
        a, b = torch.as_tensor(d["a"]), torch.as_tensor(d["b"])
        red1, res = secure_agg.compress_tree_psum([a[0, R], b[0, R]], g, cfg)
        red2, res = secure_agg.compress_tree_psum([a[1, R], b[1, R]], g, cfg,
                                                  res)
        outs = red1 + red2 + res
        np.savez(OUT + f"/rank{R}.npz",
                 **{f"o{i}": o.numpy() for i, o in enumerate(outs)})
    """, tmp_path)
    ref = np.load(tmp_path / "ref.npz")
    # one quantum (shared scale / 127) of each output's leaf and round: the
    # second round's scale is at most max|g| plus the first's half quantum
    q1 = [np.max(np.abs(x[0])) / 127 for x in (a, b)]
    q2 = [(np.max(np.abs(x[1])) + q) / 127 for x, q in zip((a, b), q1)]
    quanta = q1 + q2 + q2
    for r, res in enumerate(ranks):
        for i in range(6):
            gap = np.max(np.abs(res[f"o{i}"] - ref[f"o{i}"][r]))
            assert gap <= quanta[i] * (1 + 1e-5), (r, i, gap / quanta[i])
        # where no code flipped between the packages, which is nearly
        # everywhere, the sums and residuals agree to float32 rounding
        for i in range(6):
            close = np.isclose(res[f"o{i}"], ref[f"o{i}"][r], rtol=1e-5,
                               atol=1e-7)
            assert close.mean() > 0.99, (r, i, close.mean())


def test_dp_compressed_step_matches_reference(subproc, tmp_path):
    """Three steps of the Gamma-compressed data-parallel trainer (bits 8,
    error feedback) on reduced yi_9b in float32, four ranks of one
    global batch, from the reference's weights; then five more on one
    batch, where the loss falls (the reference's test_secure_agg)."""
    subproc(f"""
        import dataclasses, numpy as np, jax, jax.numpy as jnp
        from jax.sharding import NamedSharding, PartitionSpec as P
        from repro.configs import get_reduced
        from repro.core.secure_agg import CompressionConfig
        from repro.data.pipeline import TokenPipeline
        from repro.train import loop
        from repro.train.optimizer import OptConfig
        cfg = dataclasses.replace(get_reduced("yi_9b"), dtype="float32")
        mesh = jax.make_mesh((4,), ("data",))
        step = loop.make_dp_compressed_step(
            cfg, OptConfig(lr=5e-3, warmup_steps=1, total_steps=20), mesh,
            CompressionConfig(bits=8))
        state = loop.init_dp_state(cfg, jax.random.PRNGKey(0))
        np.savez(r"{tmp_path}/init.npz", **{{
            "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(
                state["params"])[0]}})
        pipe = TokenPipeline(vocab=cfg.vocab, batch=8, seq=16)
        losses = []
        with mesh:
            for _ in range(3):
                b = {{k: jax.device_put(jnp.asarray(v),
                                       NamedSharding(mesh, P("data")))
                     for k, v in pipe.next().items()}}
                state, m = step(state, b)
                losses.append(float(m["loss"]))
        np.save(r"{tmp_path}/ref_losses.npy", np.asarray(losses))
    """, timeout=900)
    ranks = run_ranks("""
        import dataclasses
        from repro_torch import convert
        from repro_torch.configs import get_reduced
        from repro_torch.core.secure_agg import CompressionConfig
        from repro_torch.data.pipeline import TokenPipeline
        from repro_torch.train import loop, optimizer
        cfg = dataclasses.replace(get_reduced("yi_9b"), dtype="float32")
        flat = dict(np.load(OUT + "/init.npz"))
        tree = convert._nest({k.replace("/", "."): v
                              for k, v in flat.items()})
        params = convert.lm_params_from_numpy(cfg, tree, "cpu")
        params.requires_grad_(True)
        state = {"params": params, "opt": optimizer.init_opt_state(params),
                 "residuals": params.map(torch.zeros_like),
                 "step": torch.zeros((), dtype=torch.int32)}
        step = loop.make_dp_compressed_step(
            cfg, optimizer.OptConfig(lr=5e-3, warmup_steps=1,
                                     total_steps=20), g,
            CompressionConfig(bits=8))
        pipe = TokenPipeline(vocab=cfg.vocab, batch=8, seq=16)
        losses = []
        for _ in range(3):
            state, m = step(state, pipe.next(device="cpu", rank=R, world=W))
            losses.append(float(m["loss"]))
        one = pipe.next(device="cpu", rank=R, world=W)
        for _ in range(5):
            state, m = step(state, one)
            losses.append(float(m["loss"]))
        np.savez(OUT + f"/rank{R}.npz", losses=np.asarray(losses),
                 step=int(state["step"]))
    """, tmp_path, timeout=600)
    ref = np.load(tmp_path / "ref_losses.npy")
    for res in ranks:
        np.testing.assert_array_equal(res["losses"], ranks[0]["losses"])
        assert int(res["step"]) == 8
    losses = ranks[0]["losses"]
    gaps = np.abs(losses[:3] - ref) / ref
    assert gaps[0] < 1e-5 and np.max(gaps[1:]) < 1e-3, (losses[:3], ref)
    assert losses[-1] < losses[3], losses


@pytest.mark.parametrize("coupled", [False, True])
def test_spmd_admm_matches_reference(coupled, subproc, tmp_path):
    subproc(f"""
        import numpy as np, jax, jax.numpy as jnp
        from repro.core import admm
        from repro.data.synthetic import make_lasso
        inst = make_lasso(40, 160, 0.05, 0.01, seed=1)
        cfg = admm.ADMMConfig(lam=0.05, iters=100, coupled={coupled})
        mesh = jax.make_mesh((4,), ("data",))
        run = admm.make_spmd_admm(mesh, cfg, 4)
        with mesh:
            x, objs = run(jnp.asarray(inst.A), jnp.asarray(inst.y))
        np.savez(r"{tmp_path}/ref.npz", x=np.asarray(x),
                 objs=np.asarray(objs))
    """)
    ranks = run_ranks(f"""
        from repro_torch.core import admm
        from repro_torch.data.synthetic import make_lasso
        inst = make_lasso(40, 160, 0.05, 0.01, seed=1)
        cfg = admm.ADMMConfig(lam=0.05, iters=100, coupled={coupled})
        Ak = admm.split_columns(inst.A, W)[R]
        x, objs = admm.make_spmd_admm(g, cfg, W)(Ak, inst.y)
        np.savez(OUT + f"/rank{{R}}.npz", x=x.numpy(), objs=objs.numpy())
    """, tmp_path)
    ref = np.load(tmp_path / "ref.npz")
    x = np.concatenate([r["x"] for r in ranks])
    assert x.dtype == np.float64
    assert np.max(np.abs(x - ref["x"])) < 1e-10
    for r in ranks:
        assert np.max(np.abs(r["objs"] - ref["objs"])) < 1e-10 * np.max(
            np.abs(ref["objs"]))


def test_train_step_over_two_ranks_equals_one_rank(tmp_path):
    """Data parallelism in ``make_train_step``: two ranks on half a batch
    each, gradients and loss averaged, against one process on the whole
    batch (float32, reduced yi_9b); then each rank restores rank 0's
    checkpoint onto its own device (``fault.elastic_restore``)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_reduced
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.train import loop, optimizer
    ranks = run_ranks("""
        import dataclasses
        from repro_torch.configs import get_reduced
        from repro_torch.data.pipeline import TokenPipeline
        from repro_torch.train import loop, optimizer
        cfg = dataclasses.replace(get_reduced("yi_9b"), dtype="float32")
        step = loop.make_train_step(cfg, optimizer.OptConfig(
            lr=1e-2, warmup_steps=1, total_steps=6), group=g)
        state = loop.init_train_state(cfg, 0, "cpu")
        pipe = TokenPipeline(cfg.vocab, 4, 16)
        out = []
        for _ in range(3):
            state, m = step(state, pipe.next(device="cpu", rank=R, world=W))
            out.append([float(m["loss"]), float(m["grad_norm"])])
        # rank 0 checkpoints; every rank restores onto its own device
        import torch.distributed as dist
        from repro_torch.train import checkpoint, fault
        if R == 0:
            checkpoint.save(OUT + "/ck", 3, state)
        dist.barrier(g)
        back, _ = fault.elastic_restore(OUT + "/ck", state, device="cpu",
                                        group=g)
        assert int(back["step"]) == 3
        for a, b in zip(back["params"].parameters(),
                        state["params"].parameters()):
            assert torch.equal(a, b) and a.requires_grad
        np.savez(OUT + f"/rank{R}.npz", out=np.asarray(out), **{
            n: p.detach().numpy()
            for n, p in state["params"].named_parameters()})
    """, tmp_path, world=2)
    cfg = dataclasses.replace(get_reduced("yi_9b"), dtype="float32")
    ocfg = optimizer.OptConfig(lr=1e-2, warmup_steps=1, total_steps=6)
    step = loop.make_train_step(cfg, ocfg)
    state = loop.init_train_state(cfg, 0, "cpu")
    pipe = TokenPipeline(cfg.vocab, 4, 16)
    want = []
    for _ in range(3):
        state, m = step(state, pipe.next(device="cpu"))
        want.append([float(m["loss"]), float(m["grad_norm"])])
    for res in ranks:
        assert np.max(np.abs(res["out"] - want) / np.asarray(want)) < 1e-5
        for n, p in state["params"].named_parameters():
            assert np.max(np.abs(res[n] - p.detach().numpy())) \
                <= 0.05 * ocfg.lr, n
    assert isinstance(state["step"], torch.Tensor)


def _metrics(out: str, key: str) -> list:
    return [float(ln.split(f"{key}=")[1].split()[0])
            for ln in out.splitlines() if ln.startswith("step")]


def test_train_cli_mesh_two_ranks_equals_one(tmp_path):
    """``--mesh 2``: two gloo ranks, each on half of every global batch,
    gradients averaged; losses and grad norms as one rank's on the whole
    batch (a sum in place of the mean would double the grad norm)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    base = [sys.executable, "-m", "repro_torch.launch.train", "--device",
            "cpu", "--arch", "yi_9b", "--reduced", "--steps", "4",
            "--batch", "4", "--seq", "16", "--log-every", "1"]
    outs = []
    for extra in (["--mesh", "1"], ["--mesh", "2", "--ckpt-dir",
                                    str(tmp_path)]):
        r = subprocess.run(base + extra, capture_output=True, text=True,
                           timeout=600, env=env, cwd=REPO)
        assert r.returncode == 0, r.stderr[-3000:]
        assert "done: 4 steps" in r.stdout
        outs.append(r.stdout)
    losses = [_metrics(o, "loss") for o in outs]
    gnorms = [_metrics(o, "gnorm") for o in outs]
    assert len(losses[0]) == 4
    np.testing.assert_allclose(losses[1], losses[0], atol=1e-2)
    np.testing.assert_allclose(gnorms[1], gnorms[0], rtol=2e-2)
    assert os.path.isdir(tmp_path / "step_00000004")
