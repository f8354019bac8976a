"""Plain reference of a dense decoder language model's train step.

What the port's ``train.loop.make_train_step`` must reproduce, in plain
``torch`` and float32 with TF32 off; it imports nothing of the program.
The block is the Llama-style decoder that Yi-9B (arXiv:2403.04652)
publishes:

* x = E[tokens];
* each layer: h = RMSNorm(x); q, k, v = h Wq, h Wk, h Wv; RoPE on q and
  k (the half-split rotation at base ``rope_theta``); causal
  softmax(q k^T / sqrt(hd)) v, each key-value head shared by
  ``n_heads / n_kv`` query heads (GQA); x += o Wo; h = RMSNorm(x);
  x += (silu(h Wg) * (h Wu)) Wd;
* logits = RMSNorm(x) Wout; the loss is the mean over the tokens of
  logsumexp(logits) - logits[label].

Departures from the published description, each the same function:
RMSNorm(x) = x / sqrt(mean(x^2) + eps) * (1 + w) holds its scale as 1 + w
with w starting at 0; the vocabulary of E and Wout is padded to a
multiple of ``pad_vocab_multiple`` rows (default 128), whose logits take
part in the logsumexp, and tokens are drawn below ``vocab``.

The optimizer is AdamW: global-norm clipping, a linear warm-up then a
cosine decay to a tenth of ``lr``, bias-corrected moments, the step
``m / (sqrt(v) + eps)``, and decoupled weight decay on every leaf but the
final norm's scale (a per-layer scale decays, as it does where the
layers are stacked into one array, which makes it a matrix).

Parameters are a dict of float32 tensors by name (:func:`param_specs`,
drawn by :func:`make_params` from the seed).  Every matrix product goes
through ``mm``: the benchmark's control passes :func:`fp8_mm`, which
rounds both operands to float8.  Each layer is recomputed in the
backward pass (``torch.utils.checkpoint``) and attention's scores are
held one sequence at a time, so that the reference fits beside nothing
else on one card at the benchmark's sizes.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

#: float8 (e4m3)'s largest finite value
FP8_MAX = 448.0


def padded_vocab(cfg: dict) -> int:
    m = cfg.get("pad_vocab_multiple", 128)
    return -(-cfg["vocab"] // m) * m


def head_dim(cfg: dict) -> int:
    return cfg.get("head_dim") or cfg["d_model"] // cfg["n_heads"]


def param_specs(cfg: dict) -> dict:
    """``{name: (shape, scale)}``: entries N(0, scale^2), or zeros where
    the scale is 0 (the norms' w)."""
    d, ff, hd = cfg["d_model"], cfg["d_ff"], head_dim(cfg)
    H, KV, V = cfg["n_heads"], cfg["n_kv"], padded_vocab(cfg)
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
            n = math.prod(shape)
            out[name] = flat[at:at + n].view(shape).mul_(scale)
            at += n
        else:
            out[name] = torch.zeros(shape, dtype=torch.float32,
                                    device=device)
    return out


def decays(name: str, p: torch.Tensor) -> bool:
    return p.ndim >= 2 or name.startswith("layers.")


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 at a per-tensor scale that maps its
    largest magnitude to the format's largest; the gradient passes as
    through the identity."""
    amax = t.detach().abs().amax().clamp(min=1e-30)
    q = (t.detach() * (FP8_MAX / amax)).to(torch.float8_e4m3fn)
    return t + (q.to(torch.float32) * (amax / FP8_MAX) - t.detach())


def fp8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A matrix product of float8-rounded operands, in float32."""
    return _fp8(a) @ _fp8(b)


def rms_norm(x, w, eps: float):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * (1.0 + w)


def rope(x, theta: float):
    """x (B, S, heads, hd); position s rotates pair (i, i + hd/2) by
    s * theta^(-2i/hd)."""
    S, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, mm):
    """Causal GQA attention: q (B, S, H, hd), k and v (B, S, KV, hd)."""
    B, S, H, hd = q.shape
    rep = H // k.shape[2]
    future = torch.ones(S, S, dtype=torch.bool, device=q.device).triu(1)
    out = []
    for b in range(B):
        qb = q[b].transpose(0, 1)                         # (H, S, hd)
        kb = k[b].transpose(0, 1).repeat_interleave(rep, 0)
        vb = v[b].transpose(0, 1).repeat_interleave(rep, 0)
        s = mm(qb, kb.transpose(1, 2)) / math.sqrt(hd)
        s = s.masked_fill(future, float("-inf"))
        out.append(mm(torch.softmax(s, dim=-1), vb))
    return torch.stack(out).transpose(1, 2)              # (B, S, H, hd)


def layer(x, params: dict, i: int, cfg: dict, mm):
    p = {k[len(f"layers.{i}."):]: t for k, t in params.items()
         if k.startswith(f"layers.{i}.")}
    B, S, _ = x.shape
    H, KV, hd = cfg["n_heads"], cfg["n_kv"], head_dim(cfg)
    eps, theta = cfg["norm_eps"], cfg["rope_theta"]
    h = rms_norm(x, p["ln_attn"], eps)
    q = rope(mm(h, p["attn.wq"]).view(B, S, H, hd), theta)
    k = rope(mm(h, p["attn.wk"]).view(B, S, KV, hd), theta)
    v = mm(h, p["attn.wv"]).view(B, S, KV, hd)
    o = attention(q, k, v, mm).reshape(B, S, H * hd)
    x = x + mm(o, p["attn.wo"])
    h = rms_norm(x, p["ln_mlp"], eps)
    return x + mm(F.silu(mm(h, p["mlp.w_gate"])) * mm(h, p["mlp.w_up"]),
                  p["mlp.w_down"])


def loss(params: dict, tokens, labels, cfg: dict, mm=torch.matmul):
    """Mean next-token loss of one batch (tokens and labels (B, S))."""
    x = params["embed"][tokens]
    for i in range(cfg["n_layers"]):
        x = checkpoint(layer, x, params, i, cfg, mm, use_reentrant=False)
    logits = mm(rms_norm(x, params["ln_f"], cfg["norm_eps"]),
                params["head"])
    ll = torch.gather(logits, -1, labels[..., None])[..., 0]
    return torch.mean(torch.logsumexp(logits, dim=-1) - ll)


def learning_rate(count: int, opt: dict) -> float:
    warm = min(count / max(opt["warmup_steps"], 1), 1.0)
    prog = min(max((count - opt["warmup_steps"])
                   / max(opt["total_steps"] - opt["warmup_steps"], 1),
                   0.0), 1.0)
    return opt["lr"] * warm * (0.1 + 0.9 * 0.5 * (1 + math.cos(math.pi
                                                              * prog)))


@torch.no_grad()
def adamw(params: dict, grads: dict, m: dict, v: dict, count: int,
          opt: dict) -> float:
    """One AdamW step in place; returns the clipping's scale."""
    gnorm = math.sqrt(sum(float(torch.sum(g * g)) for g in grads.values()))
    scale = min(opt["clip_norm"] / max(gnorm, 1e-12), 1.0)
    lr = learning_rate(count, opt)
    b1, b2 = opt["b1"], opt["b2"]
    b1c, b2c = 1.0 - b1 ** count, 1.0 - b2 ** count
    for name, p in params.items():
        g = grads[name] * scale
        m[name].mul_(b1).add_(g, alpha=1.0 - b1)
        v[name].mul_(b2).addcmul_(g, g, value=1.0 - b2)
        step = (m[name] / b1c) / ((v[name] / b2c).sqrt() + opt["eps"])
        if decays(name, p):
            step += opt["weight_decay"] * p
        p.sub_(lr * step)
    return scale


def follow(cfg: dict, opt: dict, params: dict, batches, mm=torch.matmul):
    """Train ``params`` (updated in place) one step a batch of
    ``batches`` (``(tokens, labels)``); returns ``{"losses": [...],
    "grad_norms": {name: norm}}``, the second of the first step's
    gradients as the optimizer applies them (clipped)."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        m = {n: torch.zeros_like(p) for n, p in params.items()}
        v = {n: torch.zeros_like(p) for n, p in params.items()}
        losses, grad_norms = [], {}
        for count, (tokens, labels) in enumerate(batches, 1):
            for p in params.values():
                p.requires_grad_(True)
                p.grad = None
            value = loss(params, tokens, labels, cfg, mm)
            value.backward()
            grads = {n: p.grad for n, p in params.items()}
            scale = adamw(params, grads, m, v, count, opt)
            if count == 1:
                grad_norms = {n: float(torch.linalg.vector_norm(g)) * scale
                              for n, g in grads.items()}
            losses.append(float(value.detach()))
            for p in params.values():
                p.grad = None
                p.requires_grad_(False)
        return {"losses": losses, "grad_norms": grad_norms}
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


def change_norms(params: dict, before: dict) -> dict:
    """``{name: |params - before|}``, leaf by leaf."""
    return {n: float(torch.linalg.vector_norm(p - before[n]))
            for n, p in params.items()}
