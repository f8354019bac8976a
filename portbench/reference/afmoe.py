"""Plain reference of an afmoe language model's train step (Trinity-Mini,
https://huggingface.co/arcee-ai/Trinity-Mini, and the afmoe block
published with it in transformers' ``modeling_afmoe.py``).

What the port's ``train.loop.make_train_step`` must reproduce, in plain
``torch`` and float32 with TF32 off; it imports nothing of the program.
Sizes come from the configuration's keys (``n_layers``, ``d_model``,
``n_heads``, ``n_kv``, ``head_dim``, ``d_ff``, ``moe_d_ff``,
``n_experts``, ``top_k``, ``window``, ``global_every``, ...):

* x = E[tokens] * sqrt(d_model) (``mup_enabled``);
* each layer i: h = RMSNorm(x); q, k, v = h Wq, h Wk, h Wv, split into
  heads; q and k each through a per-head RMSNorm (head_dim wide); on a
  windowed layer (i % global_every != global_every - 1) RoPE on q and k
  (the half-split rotation at base ``rope_theta``) and a causal mask
  that keeps the last ``window`` positions; on the other layers full
  causal attention with no positional encoding; softmax(q k^T /
  sqrt(hd)) v, each key-value head shared by ``n_heads / n_kv`` query
  heads; o = o * sigmoid(h Wg) over the heads' concatenated output;
  x += RMSNorm(o Wo); h = RMSNorm(x); x += RMSNorm(ffn(h));
* ffn: on the first ``dense_layers`` layers (silu(h Wg) * (h Wu)) Wd at
  ``d_ff``; after them, scores s = sigmoid(h W_r) over every expert, the
  top ``top_k`` chosen on s + b (b the layer's selection bias), weights
  w_j = route_scale * s_j / sum of the chosen s (from s without b), and
  ffn(h) = shared(h) + sum over the chosen experts of w_j expert_j(h),
  each expert a SwiGLU at ``moe_d_ff``, with no capacity: each expert
  runs as a loop over the tokens routed to it;
* logits = RMSNorm(x) Wout; the loss is the mean over the tokens of
  logsumexp(logits) - logits[label].

After each step b_e += load_balance_coeff * sign(mean(c) - c_e) for
every expert e, c the step's assignment counts over every expert
(DeepSeek-V3, arXiv:2412.19437 section 2.1.2; ``bias_rate``).

Departures from the published description, each the same function or
the deployment's share: every RMSNorm holds its scale as 1 + w with w
starting at 0 (x / sqrt(mean(x^2) + eps) * (1 + w)); the vocabulary is
the configuration's slice (the traffic's ids are drawn from it, the
loss is over it), padded to a multiple of ``pad_vocab_multiple``;
only the experts this device holds (``experts_held`` from
``experts_first``) are computed, the router scoring all of them, so
what the other experts would add is left out, as in the program.

The optimizer is :mod:`lm`'s AdamW (the bias is not a parameter: no
gradient, no decay).  Every matrix product goes through ``mm`` (the
control's float8 products, ``fp8_mm``).  Each layer is recomputed in the
backward pass and attention is held one sequence and one key-value head
group at a time, each recomputed too, so that the reference fits on one
card beside nothing else.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

# change_norms and fp8_mm are read from the configuration's reference
# module by the train driver and the control script
from .lm import adamw, change_norms, fp8_mm, rms_norm, rope  # noqa: F401


def padded_vocab(cfg: dict) -> int:
    m = cfg.get("pad_vocab_multiple", 128)
    return -(-cfg["vocab"] // m) * m


def held(cfg: dict) -> range:
    first = cfg.get("experts_first", 0)
    return range(first, first + (cfg.get("experts_held") or
                                 cfg["n_experts"]))


def window(cfg: dict, i: int) -> int:
    every = cfg.get("global_every", 0)
    return 0 if every and i % every == every - 1 else cfg.get("window", 0)


def is_moe(cfg: dict, i: int) -> bool:
    return i >= cfg.get("dense_layers", 0)


def param_specs(cfg: dict) -> dict:
    """``{name: (shape, scale)}`` under the program's leaf names: entries
    N(0, scale^2), or zeros where the scale is 0 (the norms' w)."""
    d, ff, eff, hd = cfg["d_model"], cfg["d_ff"], cfg["moe_d_ff"], \
        cfg["head_dim"]
    H, KV, V, E = cfg["n_heads"], cfg["n_kv"], padded_vocab(cfg), \
        cfg["n_experts"]
    n, shared = len(held(cfg)), eff * cfg["n_shared_experts"]
    specs = {"embed": ((V, d), 0.01)}
    for i in range(cfg["n_layers"]):
        pre = f"layers.{i}."
        specs.update({
            pre + "ln_attn": ((d,), 0.0),
            pre + "ln_mlp": ((d,), 0.0),
            pre + "attn.wq": ((d, H * hd), d ** -0.5),
            pre + "attn.wk": ((d, KV * hd), d ** -0.5),
            pre + "attn.wv": ((d, KV * hd), d ** -0.5),
            pre + "attn.wo": ((H * hd, d), (H * hd) ** -0.5),
            pre + "attn.wg": ((d, H * hd), d ** -0.5),
            pre + "attn.q_norm": ((hd,), 0.0),
            pre + "attn.k_norm": ((hd,), 0.0),
            pre + "ln_attn_post": ((d,), 0.0),
            pre + "ln_mlp_post": ((d,), 0.0),
        })
        if is_moe(cfg, i):
            specs.update({
                pre + "moe.router": ((d, E), d ** -0.5),
                pre + "moe.we_gate": ((n, d, eff), d ** -0.5),
                pre + "moe.we_up": ((n, d, eff), d ** -0.5),
                pre + "moe.we_down": ((n, eff, d), eff ** -0.5),
                pre + "moe.shared.w_gate": ((d, shared), d ** -0.5),
                pre + "moe.shared.w_up": ((d, shared), d ** -0.5),
                pre + "moe.shared.w_down": ((shared, d), shared ** -0.5),
            })
        else:
            specs.update({
                pre + "mlp.w_gate": ((d, ff), d ** -0.5),
                pre + "mlp.w_up": ((d, ff), d ** -0.5),
                pre + "mlp.w_down": ((ff, d), ff ** -0.5),
            })
    specs["ln_f"] = ((d,), 0.0)
    specs["head"] = ((d, V), d ** -0.5)
    return specs


def make_params(cfg: dict, seed: int, device) -> dict:
    """The parameters for one seed: one ``torch.Generator`` on
    ``device``, one draw for every random leaf (each a view of it)."""
    specs = param_specs(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2 ** 63)
    total = sum(math.prod(shape) for shape, scale in specs.values()
                if scale)
    flat = torch.randn(total, generator=gen, device=device,
                       dtype=torch.float32)
    out, at = {}, 0
    for name, (shape, scale) in specs.items():
        if scale:
            k = math.prod(shape)
            out[name] = flat[at:at + k].view(shape).mul_(scale)
            at += k
        else:
            out[name] = torch.zeros(shape, dtype=torch.float32,
                                    device=device)
    return out


def _heads(q, k, v, mask, mm):
    """One sequence's heads of one key-value group: q (rep, S, hd), k and
    v (S, hd)."""
    s = mm(q, k.T) / math.sqrt(q.shape[-1])
    return mm(torch.softmax(s.masked_fill(mask, float("-inf")), dim=-1), v)


def attention(q, k, v, mm, win: int):
    """Causal GQA attention, the last ``win`` positions a row (0: all):
    q (B, S, H, hd), k and v (B, S, KV, hd)."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    rep = H // KV
    pos = torch.arange(S, device=q.device)
    gap = pos[:, None] - pos[None, :]
    mask = (gap < 0) | (gap >= win) if win else gap < 0
    out = torch.empty_like(q)
    for b in range(B):
        for g in range(KV):
            qs = q[b, :, g * rep:(g + 1) * rep].transpose(0, 1)
            o = checkpoint(_heads, qs, k[b, :, g], v[b, :, g], mask, mm,
                           use_reentrant=False)
            out[b, :, g * rep:(g + 1) * rep] = o.transpose(0, 1)
    return out


def swiglu(x, wg, wu, wd, mm):
    return mm(F.silu(mm(x, wg)) * mm(x, wu), wd)


def route(x, p: dict, cfg: dict, mm, bias):
    """Tokens x (T, d) -> the chosen experts (T, top_k) and their
    weights."""
    scores = torch.sigmoid(mm(x, p["moe.router"]))
    top = torch.sort(scores + bias, dim=-1, descending=True,
                     stable=True).indices[:, :cfg["top_k"]]
    w = torch.gather(scores, 1, top)
    return top, cfg["route_scale"] * w / w.sum(dim=-1, keepdim=True)


def experts(h, p: dict, cfg: dict, mm, bias, counts: dict, i: int):
    """The held experts' part of the routed sum plus the shared expert;
    the layer's assignment counts over every expert go to ``counts[i]``."""
    B, S, d = h.shape
    x = h.reshape(B * S, d)
    top, w = route(x, p, cfg, mm, bias)
    counts[i] = torch.bincount(top.reshape(-1),
                               minlength=cfg["n_experts"]).float()
    y = swiglu(x, p["moe.shared.w_gate"], p["moe.shared.w_up"],
               p["moe.shared.w_down"], mm)
    for j, e in enumerate(held(cfg)):
        tok, slot = (top == e).nonzero(as_tuple=True)
        if len(tok):
            out = swiglu(x[tok], p["moe.we_gate"][j], p["moe.we_up"][j],
                         p["moe.we_down"][j], mm)
            y = y.index_add(0, tok, out * w[tok, slot][:, None])
    return y.reshape(B, S, d)


def layer(x, params: dict, i: int, cfg: dict, mm, bias, counts: dict):
    p = {k[len(f"layers.{i}."):]: t for k, t in params.items()
         if k.startswith(f"layers.{i}.")}
    B, S, _ = x.shape
    H, KV, hd = cfg["n_heads"], cfg["n_kv"], cfg["head_dim"]
    eps, win = cfg["norm_eps"], window(cfg, i)
    h = rms_norm(x, p["ln_attn"], eps)
    q = rms_norm(mm(h, p["attn.wq"]).view(B, S, H, hd), p["attn.q_norm"],
                 eps)
    k = rms_norm(mm(h, p["attn.wk"]).view(B, S, KV, hd), p["attn.k_norm"],
                 eps)
    v = mm(h, p["attn.wv"]).view(B, S, KV, hd)
    if win:
        q, k = rope(q, cfg["rope_theta"]), rope(k, cfg["rope_theta"])
    o = attention(q, k, v, mm, win).reshape(B, S, H * hd)
    o = o * torch.sigmoid(mm(h, p["attn.wg"]))
    x = x + rms_norm(mm(o, p["attn.wo"]), p["ln_attn_post"], eps)
    h = rms_norm(x, p["ln_mlp"], eps)
    if is_moe(cfg, i):
        y = experts(h, p, cfg, mm, bias[i], counts, i)
    else:
        y = swiglu(h, p["mlp.w_gate"], p["mlp.w_up"], p["mlp.w_down"], mm)
    return x + rms_norm(y, p["ln_mlp_post"], eps)


def loss(params: dict, tokens, labels, cfg: dict, bias: dict,
         counts: dict, mm=torch.matmul):
    """Mean next-token loss of one batch (tokens and labels (B, S))."""
    x = params["embed"][tokens] * math.sqrt(cfg["d_model"])
    for i in range(cfg["n_layers"]):
        x = checkpoint(layer, x, params, i, cfg, mm, bias, counts,
                       use_reentrant=False)
    logits = mm(rms_norm(x, params["ln_f"], cfg["norm_eps"]),
                params["head"])
    ll = torch.gather(logits, -1, labels[..., None])[..., 0]
    return torch.mean(torch.logsumexp(logits, dim=-1) - ll)


def zero_bias(cfg: dict, device) -> dict:
    return {i: torch.zeros(cfg["n_experts"], device=device)
            for i in range(cfg["n_layers"]) if is_moe(cfg, i)}


def follow(cfg: dict, opt: dict, params: dict, batches, mm=torch.matmul):
    """Train ``params`` (updated in place) one step a batch of
    ``batches`` (``(tokens, labels)``), the selection biases from 0;
    returns ``{"losses": [...], "grad_norms": {name: norm}, "bias":
    {layer: bias}}``, the grad norms the first step's gradients as the
    optimizer applies them (clipped)."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        device = params["embed"].device
        bias = zero_bias(cfg, device)
        m = {n: torch.zeros_like(p) for n, p in params.items()}
        v = {n: torch.zeros_like(p) for n, p in params.items()}
        losses, grad_norms = [], {}
        for count, (tokens, labels) in enumerate(batches, 1):
            for p in params.values():
                p.requires_grad_(True)
                p.grad = None
            counts = {}
            value = loss(params, tokens, labels, cfg, bias, counts, mm)
            value.backward()
            grads = {n: p.grad for n, p in params.items()}
            scale = adamw(params, grads, m, v, count, opt)
            for i, c in counts.items():
                bias[i] += cfg["bias_rate"] * torch.sign(c.mean() - c)
            if count == 1:
                grad_norms = {n: float(torch.linalg.vector_norm(g)) * scale
                              for n, g in grads.items()}
            losses.append(float(value.detach()))
            for p in params.values():
                p.grad = None
                p.requires_grad_(False)
        return {"losses": losses, "grad_norms": grad_norms, "bias": bias}
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
