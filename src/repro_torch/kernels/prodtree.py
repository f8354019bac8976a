"""prod_rows: each row's product of N factors modulo the row's modulus —
the CUDA kernel and its plain version.

Replaces the reference's ``ops.prod_rows`` (``_prod_rows8``, jitted jnp)
and the one-modulus tree of ``paillier_vec.mul_tree`` (a
``mulmod_pallas`` launch a level): one launch of ``csrc/prodtree.cu``'s
``prod_rows_kernel`` per product.

Both bodies fold a row's factors with G groups (group g takes factors g,
g + G, g + 2G, ...) and then halve the groups in log2 G levels (group g
takes group g + s at level s = G/2, G/4, ..., 1):

* Montgomery (every modulus odd): each group starts at R mod m (R =
  2^{32 L32}) and takes the raw factors by Montgomery products, so the
  tree ends at prod * R^{1-N}; one product by R^N mod m (``corr``) makes
  it exact.  N + G products.
* Barrett (a table with an even modulus): the same fold and tree from
  1, no correction.

:func:`prod_rows_plain` runs that algorithm in plain PyTorch over the
plain REDC and Barrett (``montgomery.montmul``, ``common.barrett_mulmod``)
with G a parameter; :func:`prod_rows_limbs` takes it for a CPU tensor, at
the G the kernel would run (``geometry.tree_geometry``), and launches the
kernel for a CUDA tensor.  Results are canonical, so they equal any exact
product mod m bit for bit.

The modulus material is a :class:`common.DeviceModulus` table of T rows
(``ops._rows_table``) and a row index ``midx`` (R,) int32, or ``None``:
every row under table row 0 (``ops.prod_mod``'s one modulus).
"""
from __future__ import annotations

import dataclasses

import torch

from ..core import bigint as bi
from . import build, geometry
from . import common as cm
from . import montgomery as mg


def _row_material(table: cm.DeviceModulus,
                  midx: torch.Tensor | None) -> cm.DeviceModulus:
    """Each row's modulus material shaped to broadcast over (R, G, ·):
    table row 0 for every row without ``midx``, else row ``midx[r]`` of
    every table tensor with a group axis, (R, 1, ·)."""
    tensors = {f.name: getattr(table, f.name)
               for f in dataclasses.fields(table)
               if isinstance(getattr(table, f.name), torch.Tensor)}
    if midx is None:
        return dataclasses.replace(table, **{
            name: x[0] for name, x in tensors.items()})
    idx = midx.long()
    return dataclasses.replace(table, **{
        name: x[idx][:, None] for name, x in tensors.items()})


def prod_rows_plain(x: torch.Tensor, table: cm.DeviceModulus,
                    midx: torch.Tensor | None, reduce_impl: str, groups: int,
                    corr: torch.Tensor | None = None) -> torch.Tensor:
    """x (R, N, <=L16) radix-2^16 -> (R, L16) int32: row r's product mod
    its modulus, by G = ``groups`` (a power of two) folds and the tree
    over them, plain PyTorch.  Montgomery needs ``corr`` (T, W) = R^N mod
    each table modulus."""
    R, N, _ = x.shape
    G = groups
    if G < 1 or G & (G - 1):
        raise ValueError(f"prod_rows: {G} groups is not a power of two")
    dm = _row_material(table, midx)
    if reduce_impl == "montgomery":
        if corr is None or table.mp is None:
            raise ValueError("prod_rows: Montgomery needs every modulus odd "
                             "and the R^N correction")
        leaves = bi.fit(bi._i64(x), dm.W)

        def mul(a, b):
            return mg.montmul(a, b, dm)
        acc = bi._i64(dm.r1).expand(R, G, dm.W)
        last = corr[0] if midx is None else corr[midx.long()][:, None]
    else:
        leaves = bi.fit(bi._i64(x), table.L16)

        def mul(a, b):
            return cm.barrett_mulmod(a, b, dm)
        acc = cm.one_like(torch.zeros((R, G, table.L16), dtype=torch.int64,
                                      device=x.device))
    for i in range(0, N, G):              # factor i + g into group g
        n = min(G, N - i)
        acc = torch.cat([mul(acc[:, :n], leaves[:, i:i + n]), acc[:, n:]],
                        dim=1)
    s = G // 2
    while s:
        acc = mul(acc[:, :s], acc[:, s:2 * s])
        s //= 2
    if reduce_impl == "montgomery":
        acc = mul(acc, bi._i64(last).expand_as(acc))
    return bi.fit(acc[:, 0], table.L16).to(torch.int32)


def _require_table(name: str, table: cm.DeviceModulus,
                   midx: torch.Tensor | None, mont: bool,
                   corr: torch.Tensor | None, R: int, device) -> None:
    """Raise unless the table's kernel tensors (T rows; the correction
    too for Montgomery) lie on ``device`` as contiguous int32 of the
    widths the kernel reads, and ``midx`` is a checked row index
    (``build.require_index``): the kernel reads them unchecked."""
    T, W = int(table.mw.shape[0]), 2 * table.L32
    want = {"mw": (T, W), "muw": (T, W + 2)}
    if mont:
        want.update(r1=(T, W), mp=(T,), corr=(T, W))
    for field, shape in want.items():
        t = corr if field == "corr" else getattr(table, field)
        if t is None or tuple(t.shape) != shape or t.device != device \
                or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name}: {field} of the {T}-row modulus table "
                             f"is not a contiguous int32 {shape} on {device}")
    if midx is not None:
        build.require_index(name, cm.RowsModulus(table, midx, range(T)), R,
                            device)


def prod_rows_cuda(x: torch.Tensor, table: cm.DeviceModulus,
                   midx: torch.Tensor | None, reduce_impl: str,
                   corr: torch.Tensor | None = None, tpi: int | None = None,
                   groups: int | None = None,
                   threads: int | None = None) -> torch.Tensor:
    """The ``csrc/prodtree.cu`` kernel on CUDA tensors (same contract as
    :func:`prod_rows_plain`); x's rows and factors may have any strides
    with unit limb stride.  ``tpi``, ``groups`` and ``threads`` time
    another geometry than ``geometry.tree_geometry``'s own."""
    if x.device.type != "cuda" or x.ndim != 3 or x.shape[1] < 1 \
            or x.shape[2] > table.L16:
        raise ValueError(f"prod_rows: expected a CUDA tensor (R, N >= 1, "
                         f"<={table.L16}), got {tuple(x.shape)} on "
                         f"{x.device}")
    x = x.to(torch.int32)
    if x.stride(2) != 1:
        x = x.contiguous()
    R, N, l16 = x.shape
    mont = reduce_impl == "montgomery"
    _require_table("prod_rows", table, midx, mont, corr, R, x.device)
    out = torch.empty((R, table.L16), dtype=torch.int32, device=x.device)
    if R == 0:
        return out
    if l16 < table.L16:       # the output is as wide as the modulus
        x = bi.fit(x, table.L16)
        l16 = table.L16
    body = geometry.body_name("prod_rows", reduce_impl)
    g = geometry.tree_geometry(body, R, N, table.L32, tpi, groups, threads)
    aux = table.r1 if mont else table.muw
    launch = build.launcher("prod_rows")
    with torch.cuda.device(x.device):
        rc = launch(x.data_ptr(), x.stride(0), x.stride(1), out.data_ptr(),
                    R, N, l16, table.mw.data_ptr(), aux.data_ptr(),
                    corr.data_ptr() if mont else None,
                    table.mp.data_ptr() if mont else None,
                    None if midx is None else midx.data_ptr(), table.L32,
                    int(mont), g.tpi, g.words, g.groups, g.threads, g.blocks,
                    g.smem, torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, body)
    build.count_launch(body, R, table.L32)
    return out


def prod_rows_limbs(x: torch.Tensor, table: cm.DeviceModulus,
                    midx: torch.Tensor | None, reduce_impl: str,
                    corr: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel on a CUDA tensor, plain version (at the kernel's G) on a CPU
    tensor."""
    if x.device.type == "cuda":
        return prod_rows_cuda(x, table, midx, reduce_impl, corr)
    body = geometry.body_name("prod_rows", reduce_impl)
    g = geometry.tree_geometry(body, x.shape[0], x.shape[1], table.L32)
    return prod_rows_plain(x, table, midx, reduce_impl, g.groups, corr)
