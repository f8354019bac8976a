"""The port's LM serving path against the JAX reference on the CPU.

``repro_torch.serve.engine.Engine.generate`` gives the same greedy
tokens as ``repro.serve.engine.Engine.generate`` for all ten reduced
architectures in float32, with the reference's parameters carried across
by ``repro_torch.convert.lm_params_from_numpy`` (in bfloat16 greedy
tokens can be held equal only to a tolerance, and the MoE archs' routes
flip, so float32 is the gate).  ``python -m repro_torch.launch.serve``
runs with ``--device cpu`` and, without it on a machine with no card,
exits non-zero with ``resolve_device``'s message.
"""
import dataclasses
import functools
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, get_reduced
from repro.models import registry as ref_registry
from repro.serve.engine import Engine as RefEngine
from repro_torch import convert
from repro_torch.configs import get_reduced as port_reduced
from repro_torch.models import layers as L
from repro_torch.models import registry
from repro_torch.serve.engine import Engine, ServeConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S, MAX_NEW = 2, 8, 8


def _prompts(cfg, seed=0):
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, cfg.vocab, (B, S), dtype=np.int32)
    frames = (rng.normal(0, 0.02, (B, 8, cfg.d_model)).astype(np.float32)
              if cfg.family == "encdec" else None)
    return prompts, frames


@functools.lru_cache(maxsize=None)
def _reference(arch):
    cfg = dataclasses.replace(get_reduced(arch), dtype="float32")
    params = ref_registry.get_model(cfg).init(cfg, jax.random.PRNGKey(0))
    prompts, frames = _prompts(cfg)
    out = RefEngine(cfg, params).generate(prompts, MAX_NEW, frames=frames)
    return jax.tree.map(np.asarray, params), out


def _port_engine(arch, dtype="float32"):
    cfg = dataclasses.replace(port_reduced(arch), dtype=dtype)
    params = convert.lm_params_from_numpy(cfg, _reference(arch)[0], "cpu")
    return cfg, Engine(cfg, params)


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_equals_reference_token_for_token(arch):
    tree, want = _reference(arch)
    cfg, eng = _port_engine(arch)
    prompts, frames = _prompts(cfg)
    got = eng.generate(prompts, MAX_NEW, frames=frames)
    assert got.dtype == np.int32 and got.shape == (B, MAX_NEW)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("arch", ["yi_9b", "qwen2_moe_a27b",
                                  "seamless_m4t_medium", "recurrentgemma_2b"])
def test_held_bf16_copy_gives_the_numbers_of_a_cast_per_matmul(arch):
    """The engine casts each weight matrix once; the same model functions
    without the held copy (a cast per matmul) give identical logits."""
    cfg = port_reduced(arch)
    m = registry.get_model(cfg)
    params = m.init(cfg, 1, "cpu")
    prompts, frames = _prompts(cfg, seed=2)
    kw = {} if frames is None else {"frames": torch.as_tensor(frames)}
    tokens = torch.as_tensor(prompts).long()

    def run():
        cache = m.init_cache(cfg, B, S + 2, device="cpu")
        lg, cache = m.prefill(params, tokens, cfg, cache, **kw)
        lg2, _ = m.decode_step(params, lg.reshape(B, -1).argmax(-1), cache,
                               cfg)
        return lg, lg2

    plain = run()
    eng = Engine(cfg, params)
    assert params._held, "the engine holds no bf16 copy"
    assert all(v.dtype == torch.bfloat16 for v in params._held.values())
    held = run()
    for a, b in zip(plain, held):
        assert torch.equal(a, b)
    out = eng.generate(prompts, 4, frames=frames)
    assert out.shape == (B, 4) and (out >= 0).all()
    assert (out < cfg.padded_vocab).all()


def test_float32_engine_holds_no_copy_and_zero_new_tokens():
    cfg, eng = _port_engine("xlstm_125m")
    assert not eng.params._held
    prompts, _ = _prompts(cfg)
    assert eng.generate(prompts, 0).shape == (B, 0)
    assert ServeConfig().max_len == 256 and ServeConfig().greedy


def test_generate_continues_the_prompt_greedily():
    """Each generated token is the argmax of ``forward`` over the prompt
    and the tokens before it (float32, first maximal index)."""
    cfg, eng = _port_engine("yi_9b")
    prompts, _ = _prompts(cfg, seed=3)
    out = eng.generate(prompts, 4)
    m = registry.get_model(cfg)
    seq = torch.as_tensor(prompts).long()
    for i in range(4):
        logits = m.forward(eng.params, seq, cfg)[:, -1]
        nxt = logits.argmax(-1)
        assert np.array_equal(nxt.numpy(), out[:, i])
        seq = torch.cat([seq, nxt[:, None]], 1)


# ---------------------------------------------------------------------------
# the serve CLI
# ---------------------------------------------------------------------------

def _cli(*args, timeout=300):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *args],
        capture_output=True, text=True, timeout=timeout, env=env, cwd=REPO)


@pytest.mark.parametrize("arch", ["seamless_m4t_medium", "xlstm_125m"])
def test_serve_cli_on_cpu_prints_generated_and_sample(arch):
    r = _cli("--device", "cpu", "--arch", arch, "--reduced", "--batch", "2",
             "--prompt-len", "6", "--max-new", "5")
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.strip().splitlines()
    assert lines[0].startswith("generated (2, 5) in ")
    assert lines[0].endswith(" tok/s)")
    assert lines[1].startswith("sample: [") and len(
        eval(lines[1].split(":", 1)[1])) == 5


def test_serve_cli_main_matches_the_engine():
    from repro_torch.launch import serve
    out = serve.main(["--device", "cpu", "--arch", "yi_9b", "--reduced",
                      "--batch", "2", "--prompt-len", "4", "--max-new", "3"])
    cfg = port_reduced("yi_9b")
    params = registry.get_model(cfg).init(cfg, 0, "cpu")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (2, 4),
                                                dtype=np.int32)
    assert np.array_equal(out, Engine(cfg, params).generate(prompts, 3))


def test_serve_cli_without_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a card")
    r = _cli("--arch", "xlstm_125m", "--reduced", "--batch", "1",
             "--max-new", "1", timeout=120)
    assert r.returncode != 0
    assert r.stderr.startswith("serve: device 'cuda' requested")
    assert "generated" not in r.stdout


def test_serve_cli_refuses_an_unknown_device():
    r = _cli("--device", "tpu", "--arch", "xlstm_125m", "--reduced",
             timeout=120)
    assert r.returncode != 0 and r.stderr.startswith("serve: ")
    assert "tpu" in r.stderr and "Traceback" not in r.stderr
    assert L.cdtype(port_reduced("xlstm_125m")) == torch.bfloat16
