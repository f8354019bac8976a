"""The afmoe block in the port (Trinity-Mini): its configuration and
parameter counts, the windowed ``attention_flash`` chunk skip, dropless
sigmoid routing, the KV-cache path against ``forward``, and the train
entry point, on the CPU."""
from __future__ import annotations

import dataclasses
import math

import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs import ARCHS, ALIASES, get_config, get_reduced
from repro_torch.models import layers as L
from repro_torch.models import moe, registry


def test_published_config_and_counts():
    """About 26.1 B parameters and 3.5 B active (the gate, the q/k norms,
    the sandwich norms and the two dense layers counted); the benchmark's
    cut (8 layers, 16 of 128 experts, an eighth of the vocabulary) 1.04 B.
    Not one of the JAX package's architectures."""
    cfg = get_config("trinity_mini")
    assert "trinity_mini" not in ARCHS and "trinity_mini" not in \
        ALIASES.values()
    assert cfg.param_count() == 26_123_970_560
    assert cfg.active_param_count() == 3_474_728_960
    d, hd, H, KV = 2048, 128, 32, 4
    attn = d * H * hd * 3 + 2 * d * KV * hd + 2 * hd + 4 * d
    expert = 3 * d * 1024
    want = 32 * attn + 2 * 3 * d * 6144 + 30 * (129 * expert + d * 128) \
        + 2 * 200_192 * d + d
    assert cfg.param_count() == want
    cut = dataclasses.replace(cfg, n_layers=8, vocab=25_024,
                              experts_held=16, pad_vocab_multiple=64)
    assert cut.param_count() == 1_039_470_592
    assert cut.padded_vocab == cut.vocab
    assert [cfg.layer_window(i) for i in range(8)] == [2048] * 3 + [0] \
        + [2048] * 3 + [0]
    assert [cfg.layer_rope(i) for i in range(4)] == [True] * 3 + [False]
    assert [cfg.layer_is_moe(i) for i in range(4)] == [False] * 2 + [True] * 2
    assert list(cut.held) == list(range(16))


def test_other_configs_keep_their_layers():
    """The new fields' defaults: one window for every layer, RoPE on all,
    MoE from layer 0 for a MoE family."""
    for arch in ARCHS:
        cfg = get_config(arch)
        assert {cfg.layer_window(i) for i in range(cfg.n_layers)} == \
            {cfg.window}
        assert all(cfg.layer_rope(i) for i in range(cfg.n_layers))
        assert cfg.layer_is_moe(0) == (cfg.family == "moe")


def _flash_before(q, k, v, *, causal=True, window=0, q_chunk=512,
                  k_chunk=512):
    """``layers.attention_flash`` as it stood before the window skip,
    line for line: every key chunk, masked."""
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    k_chunk = min(k_chunk, T)
    T0 = T
    pad_k = (-T) % k_chunk
    if pad_k:
        k = F.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = F.pad(v, (0, 0, 0, 0, 0, pad_k))
        T += pad_k
    nk = T // k_chunk
    rep = H // KV
    scale = float(1.0 / math.sqrt(D))
    dev = q.device
    qg = L._group(q, KV).float() * scale
    qpos = torch.arange(S, device=dev)
    m = torch.full((B, KV, rep, S), L.MASK_VALUE, device=dev)
    l = torch.zeros((B, KV, rep, S), device=dev)
    acc = torch.zeros((B, KV, rep, S, D), device=dev)
    for kj in range(nk):
        kc = k[:, kj * k_chunk:(kj + 1) * k_chunk]
        vc = v[:, kj * k_chunk:(kj + 1) * k_chunk]
        s = torch.einsum("bsgrd,btgd->bgrst", qg, kc.float())
        kpos = kj * k_chunk + torch.arange(k_chunk, device=dev)
        mask = (kpos < T0)[None, :].expand(S, k_chunk)
        if causal:
            mask = mask & (qpos[:, None] >= kpos[None, :])
        if window:
            mask = mask & (qpos[:, None] - kpos[None, :] < window)
        s = s.masked_fill(~mask, L.MASK_VALUE)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bgrst,btgd->bgrsd", p, vc.float())
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, D).to(q.dtype)


def _qkv(S, H=4, KV=2, D=16, seed=0, dtype=torch.float32):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(2, S, n, D, generator=gen).to(dtype)
            for n in (H, KV, KV)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,k_chunk,causal", [(300, 64, True),
                                              (256, 256, True),
                                              (97, 32, False)])
def test_flash_without_a_window_is_unchanged(S, k_chunk, causal, dtype):
    q, k, v = _qkv(S, dtype=dtype)
    got = L.attention_flash(q, k, v, causal=causal, k_chunk=k_chunk)
    assert torch.equal(got, _flash_before(q, k, v, causal=causal,
                                          k_chunk=k_chunk))


@pytest.mark.parametrize("S,window,q_chunk,k_chunk,causal", [
    (300, 40, 64, 64, True),      # ragged S, window under a chunk
    (300, 129, 50, 64, True),     # q and k chunks that do not align
    (517, 256, 128, 96, True),    # a window of several key chunks
    (200, 7, 32, 48, True),       # a window of a few positions
    (160, 64, 64, 32, False),     # no causal mask: every later chunk
    (96, 500, 32, 32, True),      # a window past the sequence
])
def test_windowed_flash_skip_equals_the_masked_chunks(S, window, q_chunk,
                                                      k_chunk, causal):
    """The skip visits only the key chunks a query chunk's window reaches
    and gives the numbers of the version that masks every chunk (within
    1e-6 relative: the products' summation order), and the naive
    attention's."""
    q, k, v = _qkv(S, seed=S)
    kw = dict(causal=causal, window=window, q_chunk=q_chunk,
              k_chunk=k_chunk)
    got = L.attention_flash(q, k, v, **kw)
    full = _flash_before(q, k, v, causal=causal, window=window,
                         k_chunk=k_chunk)
    assert (got - full).abs().max() <= 1e-6 * full.abs().max()
    naive = L.attention_naive(q, k, v, causal=causal, window=window)
    assert (got - naive).abs().max() <= 1e-5 * naive.abs().max()


def test_windowed_flash_visits_only_reachable_keys(monkeypatch):
    """At S = 2,048, window 512 and 256-row query chunks, each chunk
    visits one block: the keys from its first row's window on to its
    last row (at most 256 + 511 of them, not the 2,048 that masking
    every chunk visits)."""
    seen = []
    real = L._online_softmax

    def spy(qg, k, v, qpos, starts, width, *a):
        seen.append([(k0, k0 + width) for k0 in starts])
        return real(qg, k, v, qpos, starts, width, *a)
    monkeypatch.setattr(L, "_online_softmax", spy)
    q, k, v = _qkv(2048, H=2, KV=1, D=8)
    L.attention_flash(q, k, v, window=512, q_chunk=256, k_chunk=256)
    assert seen == [[(max(0, q0 - 511), q0 + 256)]
                    for q0 in range(0, 2048, 256)]


def _layer_tree(cfg, seed=0):
    init = L.Init("cpu", seed)
    tree = L.Params(moe.init_moe(init, cfg))
    moe.add_bias_state(tree, cfg)
    return tree


def test_dropless_routing_keeps_every_assignment():
    """A router rigged so that every token's first choice is expert 0:
    the capacity path drops past its capacity, the sigmoid path computes
    every token's every assignment, as a loop over the tokens does."""
    cfg = dataclasses.replace(get_reduced("trinity_mini"), dtype="float32")
    tree = _layer_tree(cfg)
    with torch.no_grad():
        tree["router"][:, 0] = 0.0
        tree["bias"][0] = 10.0        # sigmoid <= 1: expert 0 always first
    x = torch.randn(2, 32, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    with torch.no_grad():
        got = moe.moe_block(tree, x, cfg)
        xf = x.reshape(-1, cfg.d_model)
        chosen, w = moe.route(tree, xf, cfg)
        assert (chosen[:, 0] == 0).all()
        want = L.mlp(tree["shared"], xf)
        for t in range(xf.shape[0]):
            for j in range(cfg.top_k):
                e = int(chosen[t, j])
                h = F.silu(xf[t] @ tree["we_gate"][e]) * (xf[t]
                                                          @ tree["we_up"][e])
                want[t] += w[t, j] * (h @ tree["we_down"][e])
    assert (got.reshape(-1, cfg.d_model) - want).abs().max() <= \
        1e-5 * want.abs().max()
    capped = dataclasses.replace(cfg, router="softmax")
    assert moe.capacity(capped, xf.shape[0]) < xf.shape[0]


def test_counts_skip_the_recomputation_and_the_bias_moves():
    """A train step's forward counts each assignment once (not again
    where remat recomputes the block) and the bias moves by the rule."""
    cfg = dataclasses.replace(get_reduced("trinity_mini"), dtype="float32")
    tree = _layer_tree(cfg)
    for p in tree.parameters():
        p.requires_grad_(True)
    x = torch.randn(2, 16, cfg.d_model)
    y = L.remat_call(moe.moe_block, True, tree, x, cfg)
    y.square().sum().backward()
    counts = tree["counts"].clone()
    assert counts.sum() == 2 * 16 * cfg.top_k
    moe.update_bias(tree, 0.5)
    assert torch.equal(tree["bias"], 0.5 * torch.sign(counts.mean()
                                                      - counts))
    assert not tree["counts"].any()


def test_prefill_then_decode_through_the_cache_equals_forward():
    """The reduced config's prefill of 12 tokens, then decode of 6 more,
    against ``forward`` over all 18: each step's logits within 1e-4 of
    the largest, through windowed (8) and full layers."""
    cfg = dataclasses.replace(get_reduced("trinity_mini"), dtype="float32")
    m = registry.get_model(cfg)
    params = m.init(cfg, 3, "cpu")
    ids = torch.randint(0, cfg.vocab, (2, 18),
                        generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        full = m.forward(params, ids, cfg)
        cache = m.init_cache(cfg, 2, 24, dtype=torch.float32,
                             device="cpu")
        got, cache = m.prefill(params, ids[:, :12], cfg, cache)
        logits = [got[:, 0]]
        for t in range(12, 18):
            step, cache = m.decode_step(params, ids[:, t], cache, cfg)
            logits.append(step)
    scale = full.abs().max()
    for j, lg in enumerate(logits):
        assert (lg - full[:, 11 + j]).abs().max() <= 1e-4 * scale, j


def test_train_entry_point_runs_the_reduced_config(capsys):
    from repro_torch.launch import train
    met = train.main(["--arch", "trinity_mini", "--reduced", "--device",
                      "cpu", "--steps", "3", "--batch", "2", "--seq", "16",
                      "--log-every", "1"])
    assert math.isfinite(float(met["loss"]))
    assert "done: 3 steps" in capsys.readouterr().out
