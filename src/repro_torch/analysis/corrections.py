"""Analytic loop-trip corrections of the reference's XLA cost counts.

Port of ``repro.analysis.corrections``, arithmetic on the config whose
outputs equal the reference's.  XLA's cost_analysis counts every
``while`` body once, so the reference's dry-run adds, per cell, the
flops and bytes of the trips it did not count:

1. flash attention (layers.attention_flash): lax.map over n_q chunks x
   lax.scan over n_k chunks; counted = ONE (q_chunk x k_chunk) block per
   layer; true = the causal/windowed block triangle.
2. xLSTM recurrent scans (sLSTM always; mLSTM during prefill state
   replay): counted = one timestep; true = S timesteps.

The port's dry-run needs none of it: its flash attention and sLSTM are
Python loops, so its counter sees every trip.  It reports
``cell_correction`` beside its own count for comparison and adds
nothing.  Corrections return GLOBAL flop/byte deltas.
"""
from __future__ import annotations

from ..models import registry, xlstm as xlstm_mod, griffin as griffin_mod

FLASH_THRESHOLD = 2048
QC = 512
KC = 512


def _attn_layers(cfg) -> list[int]:
    if cfg.family in ("dense", "moe"):
        return list(range(cfg.n_layers))
    if cfg.family == "encdec":
        return []   # handled separately (enc self + dec self + cross)
    if cfg.family == "griffin":
        return [i for i in range(cfg.n_layers)
                if griffin_mod.layer_kind(cfg, i) == "attn"]
    return []


def _flash_delta_one(B: int, S: int, T: int, H: int, hd: int,
                     causal: bool, window: int) -> tuple[float, float]:
    """(flops_delta, bytes_delta) for one attention site, global."""
    if max(S, T) < FLASH_THRESHOLD:
        return 0.0, 0.0           # naive path: fully counted
    qc, kc = min(QC, S), min(KC, T)
    counted_flops = 4.0 * B * H * qc * kc * hd
    if window:
        eff = min(window, T)
        pairs = S * eff
    elif causal:
        pairs = S * (S + 1) / 2 if S == T else S * T
    else:
        pairs = S * T
    true_flops = 4.0 * B * H * hd * pairs
    # bytes: k/v chunks re-read once per (q-chunk, k-chunk) visit (bf16)
    n_blocks = (S // qc) * (T // kc)
    blk_bytes = B * (kc * hd * 2 * 2) * (H and 1) * 1.0  # per kv-head group
    # use KV heads via H? approximate with H (upper bound); report as estimate
    counted_bytes = blk_bytes
    true_bytes = blk_bytes * n_blocks * (0.5 if causal and S == T else 1.0)
    return true_flops - counted_flops, max(true_bytes - counted_bytes, 0.0)


def cell_correction(cfg, shape_name: str) -> dict:
    """Global (flops, bytes) deltas + note for an (arch, shape) cell."""
    sh = registry.SHAPES[shape_name]
    B, S = sh["batch"], sh["seq"]
    kind = sh["kind"]
    notes = []
    d_flops = 0.0
    d_bytes = 0.0

    if kind == "decode":
        return {"flops": 0.0, "bytes": 0.0, "note": "exact (no inner loops)"}

    # attention sites
    hd = cfg.hd
    if cfg.family in ("dense", "moe"):
        Sq = S + (cfg.n_prefix if cfg.frontend == "vision" else 0)
        f, b = _flash_delta_one(B, Sq, Sq, cfg.q_heads, hd, True, cfg.window)
        if f:
            d_flops += f * cfg.n_layers
            d_bytes += b * cfg.n_layers
            notes.append(f"flash-attn x{cfg.n_layers} layers")
    elif cfg.family == "griffin":
        att = _attn_layers(cfg)
        f, b = _flash_delta_one(B, S, S, cfg.q_heads, hd, True, cfg.window)
        if f:
            d_flops += f * len(att)
            d_bytes += b * len(att)
            notes.append(f"flash-attn x{len(att)} attn layers")
    elif cfg.family == "encdec":
        Se = registry.enc_len(cfg, S)
        f1, b1 = _flash_delta_one(B, Se, Se, cfg.n_heads, hd, False, 0)
        f2, b2 = _flash_delta_one(B, S, S, cfg.n_heads, hd, True, 0)
        f3, b3 = _flash_delta_one(B, S, Se, cfg.n_heads, hd, False, 0)
        d_flops += f1 * cfg.enc_layers + (f2 + f3) * cfg.dec_layers
        d_bytes += b1 * cfg.enc_layers + (b2 + b3) * cfg.dec_layers
        if d_flops:
            notes.append("flash-attn enc+dec")
    elif cfg.family == "xlstm":
        di = int(cfg.proj_factor * cfg.d_model)
        H = cfg.n_heads
        hdi = di // H
        step = 6.0 * B * H * hdi * hdi
        if kind == "prefill":
            # prefill replays the recurrent form for every block
            d_flops += (S - 1) * step * cfg.n_layers
            notes.append("recurrent-replay prefill (all blocks)")
        else:
            n_s = sum(1 for i in range(cfg.n_layers)
                      if xlstm_mod.is_slstm(cfg, i))
            d_flops += (S - 1) * step * n_s
            if n_s:
                notes.append(f"sLSTM scan x{n_s} layers")

    return {"flops": d_flops, "bytes": d_bytes,
            "note": "; ".join(notes) if notes else "exact"}
