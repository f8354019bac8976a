"""Rank-local forms of the ops DTensor's sharding propagation cannot
carry, for the models on a device mesh.

On a ``DeviceMesh`` the parameters are ``DTensor``s
(``registry.distribute_params``) and DTensor places every activation;
these functions take over where its rules are missing, where they would
gather a large buffer, or where a loop would pay its dispatch on every
step: each runs on the local tensors of every rank and wraps the result
back (``DTensor.from_local``), with the collectives it needs made
explicit (functional collectives, which a recorder sees).  On a plain
tensor each does what the unsharded model does.  The list, and what
each costs, is in PERF.md (section 6).
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard


def settle(x: torch.Tensor) -> torch.Tensor:
    """A ``DTensor`` with its partial sums reduced (each ``Partial``
    placement made ``Replicate``); any other tensor as it is.  For a
    partial value the next op cannot take as one: a bias added to a
    partial product, a function applied per shard."""
    if not isinstance(x, DTensor) or not any(p.is_partial()
                                             for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [Replicate() if p.is_partial()
                                          else p for p in x.placements])


def whole_dim(t, dim: int):
    """``t`` with dim ``dim`` whole on every rank: a ``DTensor`` split
    over it is gathered on those mesh dims; anything else as it is."""
    if not isinstance(t, DTensor):
        return t
    split = Shard(dim % t.ndim)
    if split not in t.placements:
        return t
    return t.redistribute(t.device_mesh, [Replicate() if p == split else p
                                          for p in t.placements])


def replicated(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t`` (the same on every rank) as a replicated ``DTensor`` on
    ``mesh``, or as it is when ``mesh`` is None."""
    if mesh is None:
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def gathered(x: torch.Tensor):
    """(whole value as a plain tensor, mesh): a ``DTensor`` is
    redistributed to ``Replicate()`` on every mesh dim (an all-gather of
    its shards) and its local copy returned with its mesh; a plain
    tensor comes back as it is, with mesh None.  For ops DTensor has no
    sharding rule for (scatter and gather by computed indices), which
    then run on every rank over the whole value."""
    if not isinstance(x, DTensor):
        return x, None
    mesh = x.device_mesh
    return x.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(), mesh


def local_apply(fn, x: torch.Tensor) -> torch.Tensor:
    """Elementwise ``fn`` on each rank's shard of a ``DTensor`` (for an
    op whose backward DTensor has no sharding rule for; no collective),
    or on a plain tensor."""
    if not isinstance(x, DTensor):
        return fn(x)
    x = settle(x)
    return DTensor.from_local(fn(x.to_local()), x.device_mesh, x.placements,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


def batch_local(fn, rows, whole=()):
    """``fn(*rows, *whole)`` on each rank's batch rows: the tensors of
    ``rows`` (batch first; a plain one is the same on every rank) are
    laid out with the batch split over the mesh dims that split the
    first ``DTensor``'s batch, whole on the others, those of ``whole``
    gathered whole, and ``fn`` runs on the local tensors; its tensor
    results come back as ``DTensor``s laid out as ``rows``.  With no
    ``DTensor`` among ``rows``, ``fn`` runs on them as they are.  For
    loops over time (a recurrence is independent per row), whose every
    step would otherwise pay DTensor's dispatch."""
    lead = next((x for x in rows if isinstance(x, DTensor)), None)
    if lead is None:
        return fn(*rows, *whole)
    mesh, B = lead.device_mesh, lead.shape[0]
    pl = [Shard(0) if p == Shard(0) and B % size == 0 else Replicate()
          for p, size in zip(lead.placements, mesh.shape)]

    def local(x):
        if not isinstance(x, DTensor):
            x = replicated(x, mesh)
        return x.redistribute(mesh, pl).to_local()

    # a whole input serves each rank's rows: its gradients add over the
    # mesh dims that split the rows
    rdims = [i for i, p in enumerate(pl) if p == Shard(0)]
    out = fn(*[local(x) for x in rows],
             *[_GradSum.apply(gathered(x)[0], mesh, rdims) for x in whole])

    def back(t):
        shape = (B,) + tuple(t.shape[1:])
        return DTensor.from_local(t.contiguous(), mesh, pl, run_check=False,
                                  shape=shape,
                                  stride=torch.empty(shape,
                                                     device="meta").stride())
    return tuple(back(t) for t in out) if isinstance(out, tuple) \
        else back(out)


def local_attention(fn, q, k, v, **kw):
    """``fn`` (an attention over plain tensors) on each rank's share of
    ``DTensor`` q (B,S,H,D), k, v (B,T,KV,D): the batch stays split
    over the mesh dims that split q's batch, and the query heads over
    the first other mesh dim that divides H (tensor parallelism), with
    the key/value heads split alike where KV divides too, else gathered
    whole and narrowed to the local heads' groups.  Other mesh dims are
    gathered.  Attention is independent per row and per head, so the
    local calls need no collective; the DTensor ops they replace would
    each pay DTensor's per-op dispatch inside the chunk loops."""
    mesh = q.device_mesh
    B, H, KV = q.shape[0], q.shape[2], k.shape[2]
    rep = H // KV
    qpl, kpl, head_dim = [], [], None
    for i, size in enumerate(mesh.shape):
        if q.placements[i] == Shard(0) and B % size == 0:
            qpl.append(Shard(0))
            kpl.append(Shard(0))
        elif head_dim is None and size > 1 and H % size == 0 and (
                (H // size) % rep == 0 or rep % (H // size) == 0):
            head_dim = i
            qpl.append(Shard(2))
            kpl.append(Shard(2) if KV % size == 0 else Replicate())
        else:
            qpl.append(Replicate())
            kpl.append(Replicate())
    ql = q.redistribute(mesh, qpl).to_local()
    kl = k.redistribute(mesh, kpl).to_local()
    vl = v.redistribute(mesh, kpl).to_local()
    if head_dim is not None and kpl[head_dim] == Replicate():
        # every rank's heads read the whole k and v: their gradients add
        kl = _GradSum.apply(kl, mesh, [head_dim])
        vl = _GradSum.apply(vl, mesh, [head_dim])
        h0 = mesh.get_local_rank(head_dim) * ql.shape[2]
        g0, g1 = h0 // rep, (h0 + ql.shape[2] - 1) // rep + 1
        kl, vl = kl[:, :, g0:g1], vl[:, :, g0:g1]
        if kl.shape[2] > ql.shape[2]:            # never: rep divides
            raise AssertionError("local heads straddle a group")
        if ql.shape[2] < rep:                    # several ranks per group
            kl, vl = kl[:, :, :1], vl[:, :, :1]
    out = fn(ql, kl, vl, **kw).contiguous()
    B, S, H, D = q.shape
    return DTensor.from_local(out, mesh, qpl, run_check=False,
                              shape=q.shape, stride=(S * H * D, H * D, D, 1))


class MergeHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, o):
        out = o.reshape(*o.shape[:-2], o.shape[-2] * o.shape[-1])
        ctx.shape, ctx.placements = o.shape, out.placements
        return out

    @staticmethod
    def backward(ctx, g):
        if g.placements != ctx.placements:
            g = g.redistribute(g.device_mesh, ctx.placements)
        return g.reshape(ctx.shape)


def nll_vocab_parallel(logits, labels):
    """:func:`nll` of ``DTensor`` logits (B, S, V) with the vocabulary
    left split (Megatron's vocab-parallel cross-entropy): each rank
    takes the max, the sum of exponentials and the label's logit over
    its own vocabulary shard, and three all-reduces of (B, S) values
    combine them.  Gathering the logits instead would cost a (B, S, V)
    buffer per rank, and DTensor's rules for ``logsumexp`` and for the
    backward of ``gather`` over a split dim do."""
    mesh = logits.device_mesh
    last = logits.ndim - 1
    rows = [Shard(0) if p == Shard(0) else Replicate()
            for p in logits.placements]
    pl = [Shard(last) if p == Shard(last) else r
          for p, r in zip(logits.placements, rows)]
    # mesh dims of one rank hold the whole vocabulary: no reduction, and
    # the unsharded formula (a one-rank mesh gives the plain numbers)
    vdims = [i for i, p in enumerate(pl)
             if p == Shard(last) and mesh.size(i) > 1]
    loc = logits.redistribute(mesh, pl).to_local()
    if not isinstance(labels, DTensor):        # the same on every rank
        labels = replicated(labels, mesh)
    raw = labels.redistribute(mesh, rows).to_local()
    mask = raw >= 0
    lab = raw.clamp(min=0)
    shard = 0
    for i in vdims:                        # the first mesh dim major
        shard = shard * mesh.size(i) + mesh.get_local_rank(i)
    off, n = shard * loc.shape[-1], loc.shape[-1]

    if vdims:
        m = _reduce_over(loc.detach().amax(dim=-1), "max", mesh, vdims)
        se = _ShardSum.apply(torch.exp(loc - m[..., None]).sum(dim=-1),
                             mesh, vdims)
        lse = torch.log(se) + m
        mine = (lab >= off) & (lab < off + n)
        ll = torch.gather(loc, -1,
                          (lab - off).clamp(0, n - 1)[..., None])[..., 0]
        ll = _ShardSum.apply(ll * mine, mesh, vdims)
    else:                                  # whole vocabulary: as unsharded
        lse = torch.logsumexp(loc, dim=-1)
        ll = torch.gather(loc, -1, lab[..., None])[..., 0]
    per = DTensor.from_local((lse - ll) * mask, mesh, rows, run_check=False)
    cnt = DTensor.from_local(mask.float(), mesh, rows, run_check=False)
    return torch.sum(per) / torch.clamp(cnt.sum(), min=1.0)


def embed_vocab_parallel(table, idx):
    """Rows ``idx`` of a ``DTensor`` table (V, d) split over its
    vocabulary on some mesh dims and whole on the others: each rank
    looks up the ids in its shard, zero elsewhere, and one all-reduce
    over the vocabulary's mesh dims sums the (B, S, d) rows; the ids
    keep their batch split, and the table's gradient is summed over the
    mesh dims that split the batch.  DTensor's own rules for an index
    into a split dim leave a masked partial whose backward some
    releases cannot take."""
    mesh = table.device_mesh
    if any(p not in (Shard(0), Replicate()) for p in table.placements):
        table = whole_dim(table, 1)
    vdims = [i for i, p in enumerate(table.placements) if p == Shard(0)]
    if not isinstance(idx, DTensor):
        idx = replicated(idx, mesh)
    rows = [Shard(0) if p == Shard(0) and i not in vdims else Replicate()
            for i, p in enumerate(idx.placements)]
    rdims = [i for i, p in enumerate(rows) if p == Shard(0)]
    loc, ids = table.to_local(), idx.redistribute(mesh, rows).to_local()
    shard = 0
    for i in vdims:                        # the first mesh dim major
        shard = shard * mesh.size(i) + mesh.get_local_rank(i)
    out = _VocabRows.apply(loc, ids, shard * loc.shape[0], mesh, vdims,
                           rdims)
    shape = tuple(idx.shape) + (table.shape[1],)
    return DTensor.from_local(out, mesh, rows, run_check=False, shape=shape,
                              stride=torch.empty(shape,
                                                 device="meta").stride())


class _VocabRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, loc, ids, off, mesh, vdims, rdims):
        n = loc.shape[0]
        mine = (ids >= off) & (ids < off + n)
        pos = (ids - off).clamp(0, n - 1)
        ctx.save_for_backward(pos, mine)
        ctx.n, ctx.mesh, ctx.rdims = n, mesh, rdims
        return _reduce_over(loc[pos] * mine[..., None].to(loc.dtype), "sum",
                            mesh, vdims)

    @staticmethod
    def backward(ctx, g):
        pos, mine = ctx.saved_tensors
        grad = torch.zeros((ctx.n, g.shape[-1]), dtype=g.dtype,
                           device=g.device)
        grad.index_put_((pos,), g * mine[..., None].to(g.dtype),
                        accumulate=True)
        return (_reduce_over(grad, "sum", ctx.mesh, ctx.rdims), None, None,
                None, None, None)


def _reduce_over(t, op: str, mesh, dims):
    """``t`` all-reduced (``"sum"`` or ``"max"``) over the process groups
    of mesh dims ``dims`` (functional collectives, so a recorder sees
    them)."""
    from torch.distributed import _functional_collectives as funcol
    for d in dims:
        t = funcol.wait_tensor(funcol.all_reduce(t, op, mesh.get_group(d)))
    return t


class _ShardSum(torch.autograd.Function):
    """Sum of every rank's share over mesh dims ``dims``, whose result
    every rank then uses alike: the gradient of each share is the
    result's gradient, as it is."""

    @staticmethod
    def forward(ctx, t, mesh, dims):
        return _reduce_over(t, "sum", mesh, dims)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GradSum(torch.autograd.Function):
    """Identity whose gradient is summed over mesh dims ``dims``: for a
    whole value that each rank along them uses on its own share of the
    work, so each holds part of the gradient."""

    @staticmethod
    def forward(ctx, t, mesh, dims):
        ctx.mesh, ctx.dims = mesh, dims
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _reduce_over(g, "sum", ctx.mesh, ctx.dims), None, None
