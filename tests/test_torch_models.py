"""The port's language models against the JAX reference on the CPU.

Each ported function of ``layers``, ``moe``, ``xlstm`` and ``griffin``
takes the same numpy inputs as the reference's; then ``forward``,
``prefill`` and ``decode_step`` of all ten reduced architectures run with
the reference's parameters carried across by
``repro_torch.convert.lm_params_from_numpy``.

Tolerances: float32 forward logits within 1e-4 of the reference's,
prefill and decode logits within 1e-3 (the KV cache is bfloat16 in both
packages); bfloat16 logits within 0.15 (the reference's own bf16 parity
bound, ``tests/test_models.py``) for the eight archs without MoE.  Under
bfloat16 the MoE archs' routes flip between packages, so their block is
compared on shared bfloat16 inputs with the reference's top-k indices
asserted equal to the port's.  Integer outputs (the int8 quantizer's
codes, routes, ranks) are compared exactly.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, get_reduced
from repro.models import griffin as ref_griffin
from repro.models import layers as ref_L
from repro.models import moe as ref_moe
from repro.models import registry as ref_registry
from repro.models import transformer as ref_transformer
from repro.models import xlstm as ref_xlstm
from repro_torch import convert
from repro_torch.configs import get_reduced as port_reduced
from repro_torch.models import griffin, moe, registry, transformer, xlstm
from repro_torch.models import layers as L

B, S = 2, 16
F32_FWD, F32_CACHE, BF16 = 1e-4, 1e-3, 0.15
MOE_ARCHS = ("llama4_scout_17b_a16e", "qwen2_moe_a27b")
DENSE_ARCHS = [a for a in ARCHS if a not in MOE_ARCHS]


def t(a, dtype=None):
    """numpy -> CPU tensor (optionally cast)."""
    x = torch.as_tensor(np.asarray(a))
    return x if dtype is None else x.to(dtype)


def j(a, dtype=None):
    x = jnp.asarray(np.asarray(a))
    return x if dtype is None else x.astype(dtype)


def n(x):
    """jax array or tensor -> float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def gap(a, b) -> float:
    return float(np.max(np.abs(n(a) - n(b))))


def configs(arch, dtype):
    ref = dataclasses.replace(get_reduced(arch), dtype=dtype)
    port = dataclasses.replace(port_reduced(arch), dtype=dtype)
    return ref, port


def inputs(cfg, seed=0, S_=S):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S_)).astype(np.int32)
    frames = (rng.normal(0, 0.02, (B, 8, cfg.d_model)).astype(np.float32)
              if cfg.family == "encdec" else None)
    return toks, frames


def extras(frames, torch_side):
    if frames is None:
        return {}
    return {"frames": t(frames) if torch_side else j(frames)}


@functools.lru_cache(maxsize=None)
def reference_params(arch):
    cfg = get_reduced(arch)
    params = ref_registry.get_model(cfg).init(cfg, jax.random.PRNGKey(0))
    return params, jax.tree.map(np.asarray, params)


@functools.lru_cache(maxsize=None)
def reference_run(arch, dtype):
    """The reference's forward, prefill and one decode step on the shared
    inputs (jitted), and the decode's input token."""
    cfg, _ = configs(arch, dtype)
    m = ref_registry.get_model(cfg)
    params, _ = reference_params(arch)
    toks, frames = inputs(cfg)
    kw = extras(frames, False)
    fwd = jax.jit(lambda p, x, **k: m.forward(p, x, cfg, **k))(
        params, j(toks), **kw)
    cache = m.init_cache(cfg, B, S + 4)
    lg, cache = jax.jit(lambda p, x, c, **k: m.prefill(p, x, cfg, c, **k))(
        params, j(toks), cache, **kw)
    nxt = np.asarray(jnp.argmax(lg.reshape(B, -1), -1)).astype(np.int32)
    lg2, _ = jax.jit(lambda p, x, c: m.decode_step(p, x, c, cfg))(
        params, j(nxt), cache)
    return {"forward": n(fwd), "prefill": n(lg), "decode": n(lg2),
            "next": nxt}


def port_run(arch, dtype, nxt):
    _, cfg = configs(arch, dtype)
    m = registry.get_model(cfg)
    params = convert.lm_params_from_numpy(cfg, reference_params(arch)[1],
                                          "cpu")
    toks, frames = inputs(cfg)
    kw = extras(frames, True)
    fwd = m.forward(params, t(toks).long(), cfg, **kw)
    cache = m.init_cache(cfg, B, S + 4, device="cpu")
    lg, cache = m.prefill(params, t(toks).long(), cfg, cache, **kw)
    lg2, _ = m.decode_step(params, t(nxt).long(), cache, cfg)
    return {"forward": n(fwd), "prefill": n(lg), "decode": n(lg2)}


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_reference(arch):
    from repro.configs import get_config
    from repro_torch.configs import get_config as port_config
    defaults = {f.name: f.default
                for f in dataclasses.fields(port_config(arch))}
    for ref, port in ((get_config(arch), port_config(arch)),
                      (get_reduced(arch), port_reduced(arch))):
        # the port's fields the reference lacks (the afmoe block's) hold
        # their defaults, which leave every reference number as it is
        mine = dataclasses.asdict(port)
        assert dataclasses.asdict(ref) == {k: mine[k] for k in
                                           dataclasses.asdict(ref)}
        assert all(mine[k] == defaults[k] for k in
                   set(mine) - set(dataclasses.asdict(ref)))
        assert (ref.hd, ref.q_heads, ref.experts, ref.padded_vocab,
                ref.e_ff) == (port.hd, port.q_heads, port.experts,
                              port.padded_vocab, port.e_ff)
        assert ref.param_count() == port.param_count()
        assert ref.active_param_count() == port.active_param_count()


def test_config_tables_and_paper_setups_equal_reference():
    from repro import configs as rc
    from repro.configs import paper_admm as rp
    from repro_torch import configs as pc
    from repro_torch.configs import paper_admm as pp
    assert rc.ARCHS == pc.ARCHS and rc.ALIASES == pc.ALIASES
    for alias, name in pc.ALIASES.items():
        assert pc.get_config(alias) == pc.get_config(name)
    assert set(pc.all_configs()) == set(rc.all_configs())
    for name in ("FIG6", "FIG7"):
        ref, port = getattr(rp, name), getattr(pp, name)
        assert dataclasses.asdict(ref) == dataclasses.asdict(port)
        assert dataclasses.asdict(rp.scaled(ref, 10)) == \
            dataclasses.asdict(pp.scaled(port, 10))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def close(got, want, dtype) -> bool:
    """float32: within 1e-5; bfloat16: within one rounding step (both
    packages compute in float32 and round once)."""
    a, b = n(got), n(want)
    if dtype == torch.float32:
        return float(np.max(np.abs(a - b))) < 1e-5
    return bool(np.all(np.abs(a - b) <= np.abs(b) * 2 ** -7 + 1e-6))


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_rms_norm_and_rope_match_reference(dtype):
    jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (2, 6, 3, 16)).astype(np.float32)
    w = rng.normal(0, 0.1, (16,)).astype(np.float32)
    got = L.rms_norm(t(x, dtype), t(w), 1e-6)
    assert got.dtype == dtype
    assert close(got, ref_L.rms_norm(j(x, jd), j(w), 1e-6), dtype)
    for pos0 in (0, 37):
        pos = np.arange(pos0, pos0 + 6)[None]
        got = L.rope(t(x, dtype), t(pos), 10_000.0)
        assert got.dtype == dtype
        assert close(got, ref_L.rope(j(x, jd), j(pos), 10_000.0), dtype)


def _qkv(seed, S_=24, T=24, H=4, KV=2, D=16):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (2, S_, H, D)).astype(np.float32),
            rng.normal(0, 1, (2, T, KV, D)).astype(np.float32),
            rng.normal(0, 1, (2, T, KV, D)).astype(np.float32))


@pytest.mark.parametrize("causal, window", [(True, 0), (True, 5),
                                            (False, 0)])
def test_attention_naive_matches_reference(causal, window):
    q, k, v = _qkv(2)
    got = L.attention_naive(t(q), t(k), t(v), causal=causal, window=window)
    want = ref_L.attention_naive(j(q), j(k), j(v), causal=causal,
                                 window=window)
    assert gap(got, want) < 1e-5


@pytest.mark.parametrize("S_, T, causal, window", [
    (100, 100, True, 0), (100, 100, True, 20), (70, 45, False, 0),
    (33, 33, True, 0)])
def test_attention_flash_matches_reference_at_ragged_lengths(S_, T, causal,
                                                             window):
    """Lengths that are not chunk multiples (padding) with small chunks."""
    q, k, v = _qkv(3, S_, T)
    kw = dict(causal=causal, window=window, q_chunk=32, k_chunk=16)
    got = L.attention_flash(t(q), t(k), t(v), **kw)
    want = ref_L.attention_flash(j(q), j(k), j(v), **kw)
    assert got.shape == (2, S_, 4, 16)
    assert gap(got, want) < 1e-5
    if causal:          # and it is attention: the naive form agrees
        naive = L.attention_naive(t(q), t(k), t(v), causal=True,
                                  window=window)
        assert gap(got, naive) < 1e-4


@pytest.mark.parametrize("cache_len, window", [(1, 0), (9, 0), (24, 0),
                                               (17, 6)])
def test_attention_decode_matches_reference(cache_len, window):
    q, k, v = _qkv(4, 1, 24)
    got = L.attention_decode(t(q), t(k, torch.bfloat16), t(v, torch.bfloat16),
                             cache_len, window=window)
    want = ref_L.attention_decode(j(q), j(k, jnp.bfloat16),
                                  j(v, jnp.bfloat16), cache_len,
                                  window=window)
    assert gap(got, want) < 1e-5


def test_attention_dispatch_switches_to_flash_at_the_threshold():
    q, k, v = _qkv(5, 40, 40)
    for thr in (41, 40):
        got = L.attention(t(q), t(k), t(v), causal=True, flash_threshold=thr)
        want = ref_L.attention(j(q), j(k), j(v), causal=True,
                               flash_threshold=thr)
        assert gap(got, want) < 1e-5
    assert torch.equal(
        L.attention(t(q), t(k), t(v), flash_threshold=40),
        L.attention_flash(t(q), t(k), t(v)))


def _attn_block(arch):
    cfg, pcfg = configs(arch, "float32")
    _, tree = reference_params(arch)
    leaves = jax.tree.map(lambda a: a[0], tree["layers"])
    params = convert.lm_params_from_numpy(pcfg, reference_params(arch)[1],
                                          "cpu")
    return cfg, pcfg, leaves, params["layers"][0]


@pytest.mark.parametrize("arch", ["codeqwen15_7b", "command_r_35b"])
def test_qkv_proj_attn_out_and_mlp_match_reference(arch):
    """With and without QKV bias (codeqwen has it), GQA."""
    cfg, pcfg, ref_lp, lp = _attn_block(arch)
    rng = np.random.default_rng(6)
    x = rng.normal(0, 1, (2, 5, cfg.d_model)).astype(np.float32)
    pos = np.arange(3, 8)[None]
    bias = rng.normal(0, 0.1, ref_lp["attn"]["wq"].shape[1:]).astype(
        np.float32)
    if cfg.qkv_bias:        # the reference's init biases are zero
        ref_lp["attn"]["bq"] = bias
        lp["attn"].bq.data.copy_(t(bias))
    got = L.qkv_proj(lp["attn"], t(x), pcfg, t(pos))
    want = ref_L.qkv_proj(ref_lp["attn"], j(x), cfg, j(pos))
    for g, w in zip(got, want):
        assert gap(g, w) < 1e-5
    assert gap(L.attn_out(lp["attn"], got[0], pcfg),
               ref_L.attn_out(ref_lp["attn"], want[0], cfg)) < 1e-5
    for act in ("silu", "gelu", "relu"):
        assert gap(L.mlp(lp["mlp"], t(x), act),
                   ref_L.mlp(ref_lp["mlp"], j(x), act)) < 1e-5


def test_int8_quantizer_matches_reference_exactly():
    rng = np.random.default_rng(7)
    x = (rng.normal(0, 2, (2, 3, 2, 16)) * rng.integers(0, 2, (2, 3, 2, 1))
         ).astype(np.float32)            # some all-zero rows: scale floor
    qp, sp = transformer._kv_quantize(t(x, torch.bfloat16))
    qr, sr = ref_transformer._kv_quantize(j(x, jnp.bfloat16))
    assert qp.dtype == torch.int8
    assert np.array_equal(qp.numpy(), np.asarray(qr))
    assert np.array_equal(sp.numpy(), np.asarray(sr))
    for dt, jd in ((torch.bfloat16, jnp.bfloat16), (torch.float32,
                                                    jnp.float32)):
        got = transformer._kv_dequantize(qp, sp, dt)
        want = ref_transformer._kv_dequantize(qr, sr, jd)
        assert got.dtype == dt and gap(got, want) == 0.0


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def _moe(arch, **changes):
    cfg, pcfg = configs(arch, "float32")
    cfg = dataclasses.replace(cfg, **changes)
    pcfg = dataclasses.replace(pcfg, **changes)
    _, tree = reference_params(arch)
    ref_p = jax.tree.map(lambda a: a[0], tree["layers"])["moe"]
    params = convert.lm_params_from_numpy(pcfg, tree, "cpu")
    return cfg, pcfg, ref_p, params["layers"][0]["moe"]


def test_capacity_and_top_k_order_match_reference():
    cfg = get_reduced("qwen2_moe_a27b")
    pcfg = port_reduced("qwen2_moe_a27b")
    for T in (1, 7, 8, 64, 1000, 4096):
        for cf in (0.5, 1.25, 8.0):
            assert moe.capacity(dataclasses.replace(pcfg, capacity_factor=cf),
                                T) == ref_moe.capacity(
                dataclasses.replace(cfg, capacity_factor=cf), T)
    # ties: the lower index first, as lax.top_k
    logits = np.array([[1.0, 3.0, 3.0, 0.5, 3.0], [2.0, 2.0, 2.0, 2.0, 2.0],
                       [-1.0, 0.0, -1.0, 0.0, 5.0]], np.float32)
    for k in (1, 2, 4):
        vals, idx = moe.top_k(t(logits), k)
        rv, ri = jax.lax.top_k(j(logits), k)
        assert np.array_equal(idx.numpy(), np.asarray(ri))
        assert np.array_equal(vals.numpy(), np.asarray(rv))


@pytest.mark.parametrize("arch, capacity_factor", [
    ("qwen2_moe_a27b", 8.0), ("llama4_scout_17b_a16e", 8.0),
    ("qwen2_moe_a27b", 0.5), ("llama4_scout_17b_a16e", 0.25)])
def test_moe_block_float32_matches_reference(arch, capacity_factor):
    """Float32, with and without capacity drops."""
    cfg, pcfg, ref_p, p = _moe(arch, capacity_factor=capacity_factor)
    x = np.random.default_rng(8).normal(0, 1, (2, 16, cfg.d_model)).astype(
        np.float32)
    got = moe.moe_block(p, t(x), pcfg)
    want = ref_moe.moe_block(ref_p, j(x), cfg)
    assert gap(got, want) < 1e-5


def _routes(x_bf16, router, k):
    """The top-k expert ids the reference's router picks for x."""
    xf = x_bf16.reshape(-1, x_bf16.shape[-1]).astype(jnp.float32)
    return np.asarray(jax.lax.top_k(xf @ j(router), k)[1])


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_block_bf16_matches_reference_with_equal_routes(arch):
    cfg, pcfg = configs(arch, "bfloat16")
    _, tree = reference_params(arch)
    ref_p = jax.tree.map(lambda a: a[0], tree["layers"])["moe"]
    p = convert.lm_params_from_numpy(pcfg, tree, "cpu")["layers"][0]["moe"]
    x = np.random.default_rng(9).normal(0, 1, (2, 16, cfg.d_model)).astype(
        np.float32)
    xb = j(x, jnp.bfloat16)
    ref_routes = _routes(xb, ref_p["router"], cfg.top_k)
    xt = t(x, torch.bfloat16)
    logits = xt.reshape(-1, cfg.d_model).float() @ p["router"].float()
    port_routes = moe.top_k(logits, cfg.top_k)[1].numpy()
    assert np.array_equal(port_routes, ref_routes)
    got = moe.moe_block(p, xt, pcfg)
    want = ref_moe.moe_block(ref_p, xb, cfg)
    assert got.dtype == torch.bfloat16
    assert gap(got, want) < BF16


# ---------------------------------------------------------------------------
# xLSTM
# ---------------------------------------------------------------------------

def _xlstm_block(idx):
    cfg, pcfg = configs("xlstm_125m", "float32")
    _, tree = reference_params("xlstm_125m")
    params = convert.lm_params_from_numpy(pcfg, tree, "cpu")
    di = int(cfg.proj_factor * cfg.d_model)
    xi = np.random.default_rng(10 + idx).normal(0, 0.5, (2, 10, di)).astype(
        np.float32)
    return cfg, pcfg, tree["blocks"][idx], params["blocks"][idx], xi


def test_mlstm_parallel_and_recurrent_forms_match_reference():
    cfg, pcfg, ref_bp, bp, xi = _xlstm_block(0)
    assert gap(xlstm.mlstm_parallel(bp, t(xi), pcfg),
               ref_xlstm.mlstm_parallel(ref_bp, j(xi), cfg)) < 1e-5
    st = xlstm.mlstm_init_state(pcfg, 2, "cpu")
    rst = ref_xlstm.mlstm_init_state(cfg, 2)
    assert np.array_equal(st["m"].numpy(), np.asarray(rst["m"]))
    outs = []
    for step in range(10):
        o, st = xlstm.mlstm_decode(bp, t(xi[:, step:step + 1]), st, pcfg)
        ro, rst = ref_xlstm.mlstm_decode(ref_bp, j(xi[:, step:step + 1]),
                                         rst, cfg)
        assert gap(o, ro) < 1e-5
        outs.append(o)
        for key in ("C", "n", "m"):
            assert gap(st[key], rst[key]) < 1e-4
    # the two forms agree (the reference's own test, on the port)
    assert gap(torch.cat(outs, 1), xlstm.mlstm_parallel(bp, t(xi), pcfg)) \
        < 1e-4


def test_slstm_scan_matches_reference_from_zero_and_from_a_state():
    cfg, pcfg, ref_bp, bp, xi = _xlstm_block(2)      # block 2 is sLSTM
    assert xlstm.is_slstm(pcfg, 2) and "r_z" in bp
    out, st = xlstm.slstm_scan(bp, t(xi[:, :6]), pcfg)
    rout, rst = ref_xlstm.slstm_scan(ref_bp, j(xi[:, :6]), cfg)
    assert gap(out, rout) < 1e-5
    out, st = xlstm.slstm_scan(bp, t(xi[:, 6:]), pcfg, state=st)
    rout, rst = ref_xlstm.slstm_scan(ref_bp, j(xi[:, 6:]), cfg, state=rst)
    assert gap(out, rout) < 1e-5
    for key in ("c", "n", "m", "h"):
        assert gap(st[key], rst[key]) < 1e-5


# ---------------------------------------------------------------------------
# Griffin
# ---------------------------------------------------------------------------

def _griffin_block(idx):
    cfg, pcfg = configs("recurrentgemma_2b", "float32")
    _, tree = reference_params("recurrentgemma_2b")
    params = convert.lm_params_from_numpy(pcfg, tree, "cpu")
    return cfg, pcfg, tree["blocks"][idx], params["blocks"][idx]


def test_rg_lru_and_causal_conv_match_reference():
    cfg, pcfg, ref_bp, bp = _griffin_block(0)
    w = griffin.lru_width(pcfg)
    rng = np.random.default_rng(11)
    x = rng.normal(0, 1, (2, 12, w)).astype(np.float32)
    a, b = griffin._lru_coeffs(bp, t(x))
    ra, rb = ref_griffin._lru_coeffs(ref_bp, j(x))
    assert gap(a, ra) < 1e-6 and gap(b, rb) < 1e-6
    # sequential float32 loop against the reference's associative scan
    assert gap(griffin.rg_lru_scan(bp, t(x)),
               ref_griffin.rg_lru_scan(ref_bp, j(x))) < 1e-5
    h = rng.normal(0, 1, (2, w)).astype(np.float32)
    y, hn = griffin.rg_lru_step(bp, t(x[:, :1]), t(h))
    ry, rhn = ref_griffin.rg_lru_step(ref_bp, j(x[:, :1]), j(h))
    assert gap(y, ry) < 1e-6 and gap(hn, rhn) < 1e-6
    for dtype, jd in ((torch.float32, jnp.float32),
                      (torch.bfloat16, jnp.bfloat16)):
        state = rng.normal(0, 1, (2, cfg.conv_width - 1, w)).astype(
            np.float32)
        for st, rst in ((None, None), (t(state, dtype), j(state, jd))):
            out, ns = griffin.causal_conv(bp, t(x, dtype), st)
            rout, rns = ref_griffin.causal_conv(ref_bp, j(x, jd), rst)
            assert out.dtype == dtype and close(out, rout, dtype)
            assert gap(ns, rns) == 0.0


def test_griffin_ring_decode_wraps_like_reference():
    """Prefill, then decode past the 16-slot window of the reduced config:
    ring slots are overwritten and tagged as the reference's are."""
    cfg, pcfg = configs("recurrentgemma_2b", "float32")
    m, pm = ref_registry.get_model(cfg), registry.get_model(pcfg)
    params, tree = reference_params("recurrentgemma_2b")
    tp = convert.lm_params_from_numpy(pcfg, tree, "cpu")
    toks, _ = inputs(cfg, seed=12, S_=12)
    cache = m.init_cache(cfg, B, 0)
    tc = pm.init_cache(pcfg, B, 0, device="cpu")
    lg, cache = m.prefill(params, j(toks), cfg, cache)
    tlg, tc = pm.prefill(tp, t(toks).long(), pcfg, tc)
    assert gap(tlg, lg) < F32_CACHE
    dec = jax.jit(lambda p, x, c: m.decode_step(p, x, c, cfg))
    rng = np.random.default_rng(13)
    for _ in range(10):                   # positions 12 .. 21 > window 16
        nxt = rng.integers(0, cfg.vocab, (B,)).astype(np.int32)
        lg, cache = dec(params, j(nxt), cache)
        tlg, tc = pm.decode_step(tp, t(nxt).long(), tc, pcfg)
        assert gap(tlg, lg) < F32_CACHE
    attn = [i for i in range(pcfg.n_layers)
            if griffin.layer_kind(pcfg, i) == "attn"]
    for i in attn:
        assert np.array_equal(tc["states"][i]["pos"].numpy(),
                              np.asarray(cache["states"][i]["pos"]))
        assert gap(tc["states"][i]["k"], cache["states"][i]["k"]) < F32_CACHE
    assert tc["len"] == int(cache["len"]) == 22


# ---------------------------------------------------------------------------
# whole models, all ten reduced archs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_decode_float32_match_reference(arch):
    ref = reference_run(arch, "float32")
    got = port_run(arch, "float32", ref["next"])
    assert got["forward"].shape == ref["forward"].shape
    assert gap(got["forward"], ref["forward"]) < F32_FWD
    assert gap(got["prefill"], ref["prefill"]) < F32_CACHE
    assert gap(got["decode"], ref["decode"]) < F32_CACHE


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_forward_prefill_decode_bf16_within_reference_bound(arch):
    ref = reference_run(arch, "bfloat16")
    got = port_run(arch, "bfloat16", ref["next"])
    for key in ("forward", "prefill", "decode"):
        assert gap(got[key], ref[key]) < BF16, key


@pytest.mark.parametrize("arch", ["yi_9b", "seamless_m4t_medium"])
def test_prefill_decode_parity_with_forward(arch):
    """The reference's own check (its ``tests/test_models.py``), on the
    port in bfloat16."""
    _, cfg = configs(arch, "bfloat16")
    m = registry.get_model(cfg)
    params = m.init(cfg, 0, "cpu")
    toks, frames = inputs(cfg)
    kw = extras(frames, True)
    tokens = t(toks).long()
    full = m.forward(params, tokens, cfg, **kw)
    cache = m.init_cache(cfg, B, S + 4, device="cpu")
    lg, cache = m.prefill(params, tokens, cfg, cache, **kw)
    assert gap(lg.reshape(B, -1), full[:, -1]) < BF16
    nxt = full[:, -1].argmax(-1)
    lg2, _ = m.decode_step(params, nxt, cache, cfg)
    full2 = m.forward(params, torch.cat([tokens, nxt[:, None]], 1), cfg, **kw)
    assert gap(lg2, full2[:, -1]) < BF16


def test_int8_cache_decode_matches_reference():
    """Token-by-token decode into the int8 cache, as the reference's test
    does, then one step against the bfloat16 cache's (within 0.25)."""
    cfg, pcfg = configs("yi_9b", "float32")
    m, pm = ref_registry.get_model(cfg), registry.get_model(pcfg)
    params, tree = reference_params("yi_9b")
    tp = convert.lm_params_from_numpy(pcfg, tree, "cpu")
    toks, _ = inputs(cfg, seed=14, S_=12)
    qc = ref_transformer.init_cache(cfg, B, 18, quantized=True)
    tqc = transformer.init_cache(pcfg, B, 18, quantized=True, device="cpu")
    dec = jax.jit(lambda p, x, c: m.decode_step(p, x, c, cfg))
    for step in range(12):
        lg, qc = dec(params, j(toks[:, step]), qc)
        tlg, tqc = pm.decode_step(tp, t(toks[:, step]).long(), tqc, pcfg)
        assert gap(tlg, lg) < F32_CACHE
    for key in ("k", "v"):
        assert int(np.max(np.abs(tqc[key].numpy().astype(np.int32)
                                 - np.asarray(qc[key], np.int32)))) <= 1
    cache = pm.init_cache(pcfg, B, 18, device="cpu")
    lg_p, cache = pm.prefill(tp, t(toks).long(), pcfg, cache)
    nxt = lg_p.reshape(B, -1).argmax(-1)
    lg_bf16, _ = pm.decode_step(tp, nxt, cache, pcfg)
    lg_q, _ = pm.decode_step(tp, nxt, tqc, pcfg)
    assert gap(lg_q, lg_bf16) < 0.25


@pytest.mark.parametrize("arch", ["yi_9b", "seamless_m4t_medium"])
def test_decode_past_the_cache_clamps_to_the_last_slot(arch):
    """``dynamic_update_slice`` clamps an out-of-range start: a decode at
    len == max_len writes the last slot, in both packages."""
    cfg, pcfg = configs(arch, "float32")
    m, pm = ref_registry.get_model(cfg), registry.get_model(pcfg)
    params, tree = reference_params(arch)
    tp = convert.lm_params_from_numpy(pcfg, tree, "cpu")
    toks, frames = inputs(cfg, S_=6)
    cache = m.init_cache(cfg, B, 6)
    tc = pm.init_cache(pcfg, B, 6, device="cpu")
    lg, cache = m.prefill(params, j(toks), cfg, cache,
                          **extras(frames, False))
    _, tc = pm.prefill(tp, t(toks).long(), pcfg, tc, **extras(frames, True))
    dec = jax.jit(lambda p, x, c: m.decode_step(p, x, c, cfg))
    for step in range(3):                     # len 6, 7, 8 of 6 slots
        nxt = toks[:, step]
        lg, cache = dec(params, j(nxt), cache)
        tlg, tc = pm.decode_step(tp, t(nxt).long(), tc, pcfg)
        assert gap(tlg, lg) < F32_CACHE
        assert gap(tc["k"], cache["k"]) < F32_CACHE
    assert tc["len"] == int(cache["len"]) == 9


def test_prefix_embeds_forward_and_prefill_match_reference():
    """The VLM stub: prefix embeddings ahead of the tokens."""
    cfg, pcfg = configs("llava_next_34b", "float32")
    m, pm = ref_registry.get_model(cfg), registry.get_model(pcfg)
    params, tree = reference_params("llava_next_34b")
    tp = convert.lm_params_from_numpy(pcfg, tree, "cpu")
    toks, _ = inputs(cfg)
    pre = np.random.default_rng(15).normal(
        0, 0.02, (B, cfg.n_prefix, cfg.d_model)).astype(np.float32)
    got = pm.forward(tp, t(toks).long(), pcfg, prefix_embeds=t(pre))
    want = m.forward(params, j(toks), cfg, prefix_embeds=j(pre))
    assert got.shape == (B, S, cfg.padded_vocab)
    assert gap(got, want) < F32_FWD
    P = cfg.n_prefix
    cache = m.init_cache(cfg, B, S + P)
    tc = pm.init_cache(pcfg, B, S + P, device="cpu")
    lg, cache = m.prefill(params, j(toks), cfg, cache, prefix_embeds=j(pre))
    tlg, tc = pm.prefill(tp, t(toks).long(), pcfg, tc, prefix_embeds=t(pre))
    assert gap(tlg, lg) < F32_CACHE and tc["len"] == int(cache["len"])


@pytest.mark.parametrize("arch", ["yi_9b", "qwen2_moe_a27b",
                                  "seamless_m4t_medium", "xlstm_125m"])
def test_loss_fn_matches_reference(arch):
    cfg, pcfg = configs(arch, "float32")
    m, pm = ref_registry.get_model(cfg), registry.get_model(pcfg)
    params, tree = reference_params(arch)
    tp = convert.lm_params_from_numpy(pcfg, tree, "cpu")
    toks, frames = inputs(cfg)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1                               # masked position
    batch = {"tokens": j(toks), "labels": j(labels)}
    tbatch = {"tokens": t(toks).long(), "labels": t(labels).long()}
    if frames is not None:
        batch["frames"], tbatch["frames"] = j(frames), t(frames)
    assert abs(float(pm.loss_fn(tp, tbatch, pcfg))
               - float(m.loss_fn(params, batch, cfg))) < 1e-5


# ---------------------------------------------------------------------------
# parameters: init and lm_params_from_numpy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_init_has_the_reference_tree_shapes_and_scales(arch):
    cfg, pcfg = configs(arch, "float32")
    _, tree = reference_params(arch)
    params = registry.get_model(pcfg).init(pcfg, 3, "cpu")
    got = {k: tuple(v.shape) for k, v in params.named_parameters()}
    want = {k: tuple(v.shape) for k, v in convert.lm_params_from_numpy(
        pcfg, tree, "cpu").named_parameters()}
    assert got == want
    assert all(p.dtype == torch.float32 and not p.requires_grad
               for p in params.parameters())
    emb = params["embed"]
    assert abs(float(emb.std()) - 0.01) < 0.002
    again = registry.get_model(pcfg).init(pcfg, 3, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(params.parameters(),
                                                 again.parameters()))


def test_lm_params_from_numpy_raises_on_missing_extra_or_misshapen_leaf():
    cfg = port_reduced("yi_9b")
    _, tree = reference_params("yi_9b")
    bad = dict(tree, layers=dict(tree["layers"]))
    del bad["ln_f"]
    with pytest.raises(KeyError, match="ln_f"):
        convert.lm_params_from_numpy(cfg, bad, "cpu")
    bad = dict(tree, extra=np.zeros(3, np.float32))
    with pytest.raises(KeyError, match="extra"):
        convert.lm_params_from_numpy(cfg, bad, "cpu")
    bad = dict(tree, head=tree["head"][:, :-1])
    with pytest.raises(ValueError, match="head"):
        convert.lm_params_from_numpy(cfg, bad, "cpu")
    layers = jax.tree.map(lambda a: a, tree["layers"])
    layers["ln_attn"] = layers["ln_attn"][:1]        # one layer short
    with pytest.raises(ValueError, match="layer axis"):
        convert.lm_params_from_numpy(cfg, dict(tree, layers=layers), "cpu")


def test_entry_points_default_to_cuda_and_never_fall_back():
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a card")
    cfg = port_reduced("xlstm_125m")
    m = registry.get_model(cfg)
    with pytest.raises(RuntimeError, match="device 'cuda' requested"):
        m.init(cfg)
    with pytest.raises(RuntimeError, match="device 'cuda' requested"):
        m.init_cache(cfg, 1, 4)
    with pytest.raises(RuntimeError, match="device 'cuda' requested"):
        convert.lm_params_from_numpy(cfg, reference_params("xlstm_125m")[1])


def test_registry_tables_match_reference():
    cfg = port_reduced("xlstm_125m")
    with pytest.raises(ValueError, match="unknown family"):
        registry.get_model(dataclasses.replace(cfg, family="rnn"))
    assert registry.SHAPES == ref_registry.SHAPES
    assert all(registry.enc_len(cfg, s) == ref_registry.enc_len(cfg, s)
               for s in (16, 4096, 32768))
