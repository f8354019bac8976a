"""The port's LM examples against the reference, on the CPU.

``serve_batched`` and ``train_lm_secure`` start from the port's own
seeded weights; here the reference's weights are carried across
(``repro_torch.convert``) and the results compared within the tolerances
of ``tests/test_torch_lm_serve.py`` (greedy tokens equal, token for
token, in float32) and ``tests/test_torch_train.py`` (a train step's loss
within 1e-5 relative).  Both examples also run whole through their
``main`` on the CPU and print ``OK``: ``train_lm_secure`` on one rank and
on two gloo ranks, where the gradients cross as the Γ-compressed
all-reduce.
"""
import dataclasses
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_reduced
from repro.data.pipeline import TokenPipeline as RefPipeline
from repro.models import registry as ref_registry
from repro.serve.engine import Engine as RefEngine
from repro.train import loop as ref_loop
from repro.train.optimizer import OptConfig as RefOptConfig
from repro_torch import convert
from repro_torch.configs import get_reduced as port_reduced
from repro_torch.examples import serve_batched, train_lm_secure

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_TOL = 1e-5                        # tests/test_torch_train.py


def f32(get, arch):
    return dataclasses.replace(get(arch), dtype="float32")


@pytest.mark.parametrize("arch", serve_batched.ARCHS)
def test_serve_batched_equals_reference_token_for_token(arch):
    cfg = f32(get_reduced, arch)
    params = ref_registry.get_model(cfg).init(cfg, jax.random.PRNGKey(0))
    want = RefEngine(cfg, params).generate(serve_batched.prompts(cfg),
                                           max_new=serve_batched.MAX_NEW)
    pcfg = f32(port_reduced, arch)
    got, _ = serve_batched.serve(arch, "cpu", cfg=pcfg,
                                 params=convert.lm_params_from_numpy(
                                     pcfg, jax.tree.map(np.asarray, params),
                                     "cpu"))
    np.testing.assert_array_equal(got, np.asarray(want))


def test_serve_batched_main(capsys):
    outs = serve_batched.main(["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1] == "OK" and len(lines) == 1 + len(serve_batched.ARCHS)
    for arch, line in zip(serve_batched.ARCHS, lines):
        sample = outs[arch][0][:6].tolist()
        assert re.fullmatch(
            rf"{arch:22s} generated 4x16 tokens in \d+\.\d\ds "
            rf"\(\d+\.\d tok/s\) sample={re.escape(str(sample))}", line)


def test_train_lm_secure_losses_equal_reference():
    """Three steps of the smoke mode's loop (one rank, the plain train
    step) from the reference's weights, float32."""
    steps, batch, seq = 3, 4, 32
    cfg = f32(get_reduced, "xlstm_125m")
    opt = RefOptConfig(lr=3e-3, warmup_steps=steps // 10, total_steps=steps)
    step = jax.jit(ref_loop.make_train_step(cfg, opt, use_scan=False,
                                            remat=False))
    state = ref_loop.init_train_state(cfg, jax.random.PRNGKey(0))
    start = jax.tree.map(np.asarray, state)
    pipe = RefPipeline(vocab=cfg.vocab, batch=batch, seq=seq, seed=0)
    want = []
    for _ in range(steps):
        state, m = step(state, pipe.next())
        want.append(float(m["loss"]))
    pcfg = f32(port_reduced, "xlstm_125m")
    run = train_lm_secure.train(
        pcfg, steps, batch, seq, "cpu",
        state=convert.train_state_from_numpy(pcfg, start, "cpu"))
    np.testing.assert_allclose(run["losses"], want, rtol=LOSS_TOL)
    n_ref = sum(p.size for p in jax.tree.leaves(start["params"]))
    assert sum(p.numel() for p in run["state"]["params"].parameters()) \
        == n_ref


def _main(*args):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-m",
                        "repro_torch.examples.train_lm_secure", "--device",
                        "cpu", *args], capture_output=True, text=True,
                       timeout=600, env=env, cwd=REPO)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    return r.stdout.splitlines()


@pytest.mark.parametrize("ranks, compressed", [(1, "off"), (2, "on")])
def test_train_lm_secure_main(ranks, compressed):
    lines = _main("--ranks", str(ranks))
    assert lines[-1] == "OK"
    steps = [ln for ln in lines if ln.startswith("step ")]
    assert len(steps) == 10 and steps[-1].startswith("step   60  loss=")
    assert re.fullmatch(r"loss \d+\.\d{4} -> \d+\.\d{4} \(\d+\.\d% drop, "
                        rf"0\.3M params, compressed_allreduce={compressed}\)",
                        lines[-2])
