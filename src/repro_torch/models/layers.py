"""Shared model layers: norms, RoPE, GQA attention (naive / flash / decode),
gated MLPs, embeddings, and the parameter tree they read.

Port of ``repro.models.layers``.  Parameters live in a :class:`Params`
tree (an ``nn.Module`` whose leaves are float32 parameters, read as
``p["wq"]`` like the reference's dict pytree).  Matmuls run in the
config's compute dtype (``cdtype``: bfloat16 unless ``cfg.dtype`` is
``"float32"``); norms, softmax and RoPE angles run in float32.  A weight
is cast to the compute dtype where it is used (``Params.w``), or read
from the copy :meth:`Params.hold` cast once: the cast is exact, so both
give the same numbers.  A trainable leaf is always cast where it is
used, so its gradient reaches the float32 master weight.  ``remat_call``
is the reference's ``jax.checkpoint`` around a block.

On a device mesh the parameters are ``DTensor``s (``registry.
distribute_params``) and DTensor's sharding propagation places every
activation; ``constrain_acts`` lays the residual stream between blocks
out at the placements a launcher installs (``set_activation_sharding``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from . import spmd

ACTS = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
}

MASK_VALUE = -1e30          # the reference's mask value (not -inf)

#: subtrees the reference stacks along a leading layer axis (the port
#: keeps them as lists of per-layer trees)
STACKED = ("layers", "enc", "dec")


def cdtype(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


# ---------------------------------------------------------------------------
# Activation sharding between blocks
# ---------------------------------------------------------------------------
# The launch layer installs placements for the residual stream; block
# boundaries redistribute (B, S, D) DTensor activations to them (batch
# over the DP axes, hidden over `model`), which keeps the per-device live
# set of a wide model small.  No-op when unset, for a plain tensor, or
# where a dim does not divide.

_ACT_SHARDING = None


def set_activation_sharding(mesh, placements=None) -> None:
    """Install ``placements`` on ``mesh`` for the residual stream, or
    clear them with ``mesh=None``."""
    global _ACT_SHARDING
    _ACT_SHARDING = None if mesh is None else (mesh, tuple(placements))


def constrain_acts(x: torch.Tensor) -> torch.Tensor:
    if _ACT_SHARDING is None or x.ndim != 3 or not isinstance(x, DTensor):
        return x
    mesh, placements = _ACT_SHARDING
    if x.device_mesh != mesh:
        return x
    ways = [1] * x.ndim
    for size, pl in zip(mesh.shape, placements):
        if pl.is_shard():
            ways[pl.dim] *= size
    if any(dim % n for dim, n in zip(x.shape, ways)):
        return x
    return x.redistribute(mesh, placements)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

class Params(nn.Module):
    """A tree of parameters built from a nested dict of tensors.

    Dicts become sub-trees, lists ``nn.ModuleList``s of sub-trees, tensors
    parameters.  Leaves start frozen (the serving path); a trainer makes
    them trainable with ``requires_grad_()``.  ``p[name]`` and ``name in
    p`` read it like the reference's pytree.
    """

    def __init__(self, tree: dict):
        super().__init__()
        for name, v in tree.items():
            if isinstance(v, dict):
                self.add_module(name, Params(v))
            elif isinstance(v, (list, tuple)):
                self.add_module(name, nn.ModuleList(Params(x) for x in v))
            else:
                self.register_parameter(
                    name, nn.Parameter(v, requires_grad=False))
        self._held = {}

    def __getitem__(self, name):
        return getattr(self, name)

    def __contains__(self, name) -> bool:
        return name in self._parameters or name in self._modules

    def _copy(self, name: str, dtype: torch.dtype):
        """The held copy of a frozen leaf, else None: a trainable leaf is
        cast per use, so the graph reaches it and never reads a stale,
        detached copy."""
        if self._parameters[name].requires_grad:
            return None
        return self._held.get((name, dtype))

    def w(self, name: str, dtype: torch.dtype) -> torch.Tensor:
        """Parameter ``name`` in ``dtype``: the held copy, else a cast."""
        held = self._copy(name, dtype)
        return held if held is not None else self._parameters[name].to(dtype)

    def take(self, name: str, idx: torch.Tensor, dtype: torch.dtype):
        """Rows ``idx`` of parameter ``name`` in ``dtype`` (the embedding
        lookup; gathering before the cast gives the same numbers, and a
        trainable table's gradient rows add up in float32).  A table on a
        mesh stays split (``spmd.embed_vocab_parallel``)."""
        held = self._copy(name, dtype)
        if held is not None:
            return held[idx]
        table = self._parameters[name]
        if isinstance(table, DTensor):
            return spmd.embed_vocab_parallel(table, idx).to(dtype)
        return table[idx].to(dtype)

    def hold(self, dtype: torch.dtype) -> "Params":
        """Cast every matrix of the tree to ``dtype`` once and keep the
        copies beside the float32 parameters (vectors are cast per use).
        Raises on a trainable tree: its copies would go stale."""
        if any(p.requires_grad for p in self.parameters()):
            raise ValueError("hold() on trainable parameters: a held copy "
                             "would not follow the updates")
        for mod in self.modules():
            if isinstance(mod, Params):
                for name, p in mod._parameters.items():
                    if p.ndim >= 2 and p.dtype != dtype:
                        mod._held[(name, dtype)] = p.detach().to(dtype)
        return self

    def tree(self) -> dict:
        """The nested dict/list of leaf tensors this tree was built from."""
        out = dict(self._parameters)
        for name, mod in self._modules.items():
            out[name] = ([m.tree() for m in mod]
                         if isinstance(mod, nn.ModuleList) else mod.tree())
        return out

    def map(self, fn) -> "Params":
        """A new frozen tree of the same structure with leaves ``fn(p)``."""
        def go(t):
            if isinstance(t, dict):
                return {k: go(v) for k, v in t.items()}
            if isinstance(t, list):
                return [go(v) for v in t]
            return fn(t.detach())
        return Params(go(self.tree()))

    def ref_ndims(self) -> list:
        """Each leaf's dimensions as the reference holds it: one more
        under a stacked layer list (:data:`STACKED`)."""
        stacked = {n for n in STACKED
                   if isinstance(self._modules.get(n), nn.ModuleList)}
        return [p.ndim + (n.split(".")[0] in stacked)
                for n, p in self.named_parameters()]

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device


def remat_call(fn, remat: bool, *args):
    """``fn(*args)``; with ``remat`` and gradients on, its activations are
    recomputed in the backward pass instead of kept (the reference's
    ``jax.checkpoint``; the blocks draw no random numbers)."""
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


class Init:
    """Initial values with the reference's scales, drawn from one seeded
    ``torch.Generator`` on ``device`` (JAX's PRNG stream cannot be
    reproduced: carry the reference's values over with
    ``repro_torch.convert.lm_params_from_numpy`` to compare)."""

    def __init__(self, device, seed: int = 0):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)

    def normal(self, shape, scale: float) -> torch.Tensor:
        t = torch.randn(shape, generator=self.gen, device=self.device,
                        dtype=torch.float32)
        return t.mul_(float(scale))

    def dense(self, shape, scale: float | None = None) -> torch.Tensor:
        """``shape[-2]`` is the fan-in (a stack of matrices keeps it)."""
        return self.normal(shape, scale if scale is not None
                           else 1.0 / math.sqrt(shape[-2]))

    def embed(self, vocab: int, d: int) -> torch.Tensor:
        return self.normal((vocab, d), 0.01)

    def full(self, shape, value: float) -> torch.Tensor:
        return torch.full(shape, float(value), dtype=torch.float32,
                          device=self.device)

    def zeros(self, shape) -> torch.Tensor:
        return self.full(shape, 0.0)


class ShapeInit(Init):
    """Same tree, no values: tensors on the ``meta`` device (the shapes
    ``lm_params_from_numpy`` checks against)."""

    def __init__(self):
        self.device = torch.device("meta")

    def normal(self, shape, scale: float) -> torch.Tensor:
        return torch.empty(shape, dtype=torch.float32, device="meta")


def make_init(device=None, seed: int = 0) -> Init:
    return Init(resolve_device(device), seed)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6):
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * (1.0 + w.float())).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: (..., S, H, D) with D even; positions: (..., S) absolute indices.
    Half-split rotation; frequencies and angles in float32."""
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freqs     # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                       # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def _group(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """(B,S,H,D) -> (B,S,KV,rep,D) exposing the GQA group structure."""
    B, S, H, D = q.shape
    return q.reshape(B, S, n_kv, H // n_kv, D)


def attention_naive(q, k, v, *, causal=True, window=0, q_pos0=0, k_pos0=0):
    """Reference attention. q (B,S,H,D); k,v (B,T,KV,D). f32 softmax."""
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    qg = _group(q, KV).float()
    s = torch.einsum("bsgrd,btgd->bgrst", qg, k.float())
    s = s / math.sqrt(D)
    qpos = q_pos0 + torch.arange(S, device=q.device)
    kpos = k_pos0 + torch.arange(T, device=q.device)
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if window:
        mask &= qpos[:, None] - kpos[None, :] < window
    s = s.masked_fill(~mask, MASK_VALUE)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrst,btgd->bsgrd", p, v.float())
    return out.reshape(B, S, H, D).to(q.dtype)


def attention_flash(q, k, v, *, causal=True, window=0,
                    q_chunk=512, k_chunk=512):
    """Online-softmax chunked attention (no S x T score matrix).

    The keys are taken ``k_chunk`` at a time, padded up to a chunk
    multiple (padded key positions are masked); every query row is
    updated by each key chunk in turn, which is what the reference's map
    over ``q_chunk``-row chunks computes for each row, in the same order
    (``q_chunk`` changes no number).  The running max starts at the mask
    value and the row sum is floored at 1e-30, as in the reference.

    With a ``window`` the queries are taken ``q_chunk`` rows at a time,
    and each chunk visits only the keys its window can reach, as one
    block: the keys it skips are wholly masked for its rows, and a
    wholly masked block changes nothing that the first unmasked one does
    not reset (its correction factor is exp(mask value - max) = 0), so
    the skip changes no number beyond the products' summation order.
    One block a query chunk keeps each operation large (a block of 512
    rows by up to 512 + window - 1 keys).
    """
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    k_chunk = min(k_chunk, T)
    T0 = T
    pad_k = (-T) % k_chunk
    if pad_k:
        k = F.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = F.pad(v, (0, 0, 0, 0, 0, pad_k))
        T += pad_k
    scale = float(1.0 / math.sqrt(D))
    qg = _group(q, KV).float() * scale
    qpos = torch.arange(S, device=q.device)
    if window:
        outs = []
        for q0 in range(0, S, q_chunk):
            q1 = min(S, q0 + q_chunk)
            k0 = max(0, q0 - window + 1)
            k1 = q1 if causal else T
            outs.append(_online_softmax(qg[:, q0:q1], k, v, qpos[q0:q1],
                                        [k0], k1 - k0, T0, causal, window))
        out = torch.cat(outs, dim=3)
    else:
        out = _online_softmax(qg, k, v, qpos, range(0, T, k_chunk), k_chunk,
                              T0, causal, window)
    # (B,KV,rep,S,D) -> (B,S,H,D)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, D).to(q.dtype)


def _online_softmax(qg, k, v, qpos, starts, width, T0, causal, window):
    """Rows ``qg`` (B, Sq, KV, rep, D, scaled, at positions ``qpos``)
    updated by the key blocks ``[k0, k0 + width)``, ``k0`` in ``starts``,
    in turn -> (B, KV, rep, Sq, D)."""
    B, Sq, KV, rep, D = qg.shape
    dev = qg.device
    m = torch.full((B, KV, rep, Sq), MASK_VALUE, device=dev)
    l = torch.zeros((B, KV, rep, Sq), device=dev)
    acc = torch.zeros((B, KV, rep, Sq, D), device=dev)
    for k0 in starts:
        kc = k[:, k0:k0 + width]
        vc = v[:, k0:k0 + width]
        s = torch.einsum("bsgrd,btgd->bgrst", qg, kc.float())
        kpos = k0 + torch.arange(width, device=dev)
        mask = (kpos < T0)[None, :].expand(Sq, width)
        if causal:
            mask = mask & (qpos[:, None] >= kpos[None, :])
        if window:
            mask = mask & (qpos[:, None] - kpos[None, :] < window)
        s = s.masked_fill(~mask, MASK_VALUE)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bgrst,btgd->bgrsd", p, vc.float())
        m = m_new
    return acc / torch.clamp(l[..., None], min=1e-30)


def attention_decode(q, k_cache, v_cache, cache_len: int, *, window=0):
    """Single new token vs. a (B, Smax, KV, D) cache. q: (B, 1, H, D).
    On a mesh the query's heads are gathered whole (one token's worth)
    and the cache stays as it is split."""
    q = spmd.whole_dim(q, 2)
    B, _, H, D = q.shape
    T, KV = k_cache.shape[1], k_cache.shape[2]
    qg = _group(q, KV).float()
    s = torch.einsum("bsgrd,btgd->bgrst", qg, k_cache.float())
    s = s / math.sqrt(D)
    kpos = torch.arange(T, device=q.device)
    mask = kpos < cache_len
    if window:
        mask &= kpos >= cache_len - window
    s = s.masked_fill(~mask, MASK_VALUE)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrst,btgd->bsgrd", p, v_cache.float())
    return out.reshape(B, 1, H, D).to(q.dtype)


def attention(q, k, v, *, causal=True, window=0, flash_threshold=2048):
    """Dispatch: naive below the threshold, flash from it on.  On a mesh
    each rank attends its own rows and heads (``spmd.local_attention``)."""
    if isinstance(q, DTensor):
        return spmd.local_attention(attention, q, k, v, causal=causal,
                                window=window,
                                flash_threshold=flash_threshold)
    if q.shape[1] >= flash_threshold or k.shape[1] >= flash_threshold:
        return attention_flash(q, k, v, causal=causal, window=window)
    return attention_naive(q, k, v, causal=causal, window=window)


# ---------------------------------------------------------------------------
# Attention block params / apply
# ---------------------------------------------------------------------------

def init_attn(init: Init, cfg) -> dict:
    d, hd = cfg.d_model, cfg.hd
    H, KV = cfg.q_heads, cfg.n_kv
    p = {
        "wq": init.dense((d, H * hd)),
        "wk": init.dense((d, KV * hd)),
        "wv": init.dense((d, KV * hd)),
        "wo": init.dense((H * hd, d)),
    }
    if cfg.afmoe:
        p["wg"] = init.dense((d, H * hd))
        p["q_norm"] = init.zeros((hd,))
        p["k_norm"] = init.zeros((hd,))
    if cfg.qkv_bias:
        p["bq"] = init.zeros((H * hd,))
        p["bk"] = init.zeros((KV * hd,))
        p["bv"] = init.zeros((KV * hd,))
    return p


def qkv_proj(p: Params, x, cfg, positions, use_rope=True):
    """x (B,S,d) -> q (B,S,H,hd), k/v (B,S,KV,hd): the per-head norms
    (the afmoe block's), then RoPE unless ``use_rope`` is False."""
    B, S, _ = x.shape
    hd = cfg.hd
    dt = x.dtype
    q = x @ p.w("wq", dt)
    k = x @ p.w("wk", dt)
    v = x @ p.w("wv", dt)
    if cfg.qkv_bias:      # (a partial product takes its sum before a bias)
        q = spmd.settle(q) + p.w("bq", dt)
        k = spmd.settle(k) + p.w("bk", dt)
        v = spmd.settle(v) + p.w("bv", dt)
    q = split_heads(q, cfg.q_heads, hd)
    k = split_heads(k, cfg.n_kv, hd)
    v = split_heads(v, cfg.n_kv, hd)
    if cfg.afmoe:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def split_heads(t, n: int, hd: int):
    """(..., n * hd) -> (..., n, hd); a ``DTensor`` split over its last
    dim into a count of shards that does not divide ``n`` is gathered on
    those mesh dims first."""
    if isinstance(t, DTensor):
        from torch.distributed.tensor import Shard
        ways = 1
        for size, p in zip(t.device_mesh.shape, t.placements):
            ways *= size if p == Shard(t.ndim - 1) else 1
        if n % ways:
            t = spmd.whole_dim(t, -1)
    return t.reshape(*t.shape[:-1], n, hd)


def attn_out(p: Params, o, cfg, h=None):
    """The heads' output through ``wo``; in the afmoe block first
    gated by sigmoid(h Wg), ``h`` the attention's (normed) input."""
    o = merge_heads(o)
    if cfg.afmoe:
        gate = torch.sigmoid((h @ p.w("wg", h.dtype)).float())
        o = (o.float() * gate).to(o.dtype)
    return o @ p.w("wo", o.dtype)


def merge_heads(o):
    """(..., n, hd) -> (..., n * hd).  On a ``DTensor`` the gradient is
    laid out as the merged output was before the backward view splits
    it again (DTensor's own choice for the gradient may split the
    merged dim where the heads do not divide)."""
    if isinstance(o, DTensor):
        return spmd.MergeHeads.apply(o)
    return o.reshape(*o.shape[:-2], o.shape[-2] * o.shape[-1])


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------

def init_mlp(init: Init, d: int, ff: int) -> dict:
    return {
        "w_gate": init.dense((d, ff)),
        "w_up": init.dense((d, ff)),
        "w_down": init.dense((ff, d)),
    }


def mlp(p: Params, x, act: str = "silu"):
    dt = x.dtype
    h = ACTS[act](x @ p.w("w_gate", dt)) * (x @ p.w("w_up", dt))
    return h @ p.w("w_down", dt)


# ---------------------------------------------------------------------------
# Embedding and output head
# ---------------------------------------------------------------------------

def embed(params: Params, tokens: torch.Tensor, cfg) -> torch.Tensor:
    """The tokens' rows of the table; in the afmoe block times
    sqrt(d_model), in float32 before the cast."""
    if cfg.afmoe:
        x = params.take("embed", tokens, torch.float32)
        return (x * math.sqrt(cfg.d_model)).to(cdtype(cfg))
    return params.take("embed", tokens, cdtype(cfg))


def head_logits(params: Params, x: torch.Tensor, cfg, norm="ln_f"):
    """Final norm, then the (tied or separate) head; float32 logits."""
    x = rms_norm(x, params[norm], cfg.norm_eps)
    if cfg.tie_embeddings:
        w = params.w("embed", x.dtype).T
    else:
        w = params.w("head", x.dtype)
    return (x @ w).float()


def nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token NLL over labels >= 0 (the reference's loss); on a
    mesh, ``spmd.nll_vocab_parallel``."""
    if isinstance(logits, DTensor):
        return spmd.nll_vocab_parallel(logits, labels)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.clamp(min=0)[..., None])[..., 0]
    mask = (labels >= 0).float()
    return torch.sum((lse - ll) * mask) / torch.clamp(mask.sum(), min=1.0)

