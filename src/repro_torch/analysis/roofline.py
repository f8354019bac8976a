"""Three-term roofline of one LM step, and the limb-op roofline of the
encrypted ADMM stack.

Port of ``repro.analysis.roofline``.  The step half prices what the
dry-run (``launch.dryrun``) counted on one rank:

    compute term    = flops      / peak FLOP/s            (per card)
    memory term     = bytes      / HBM bandwidth          (per card)
    collective term = coll_bytes / (links * link rate)    (per card)

The reference parses a compiled XLA module's text for its collectives;
the port records them as the step runs (:class:`CollectiveRecorder`, a
dispatch mode over the ``_c10d_functional`` ops that DTensor's
redistributions issue) and sums ``max(result, operand)`` bytes per kind
under the reference's five kind names (:func:`collective_bytes`).

The limb half (:func:`ladder_mulmods`, :func:`limb_ops`,
:func:`achieved_vs_peak`) gives the 16-bit limb multiplications an
OpCounter ``ops`` dict implies, and the rate they were retired at over a
run's (virtual or wall) seconds against the card's peak.
"""
from __future__ import annotations

import dataclasses
import os

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

#: One H100 SXM at its 700 W limit (NVIDIA H100 data sheet, dense rates):
#: bf16 tensor-core peak, HBM3 bandwidth, and NVLink 4's 18 links of
#: 25 GB/s each way (900 GB/s per card).  A card set below 700 W runs
#: slower than these.
PEAK_FLOPS = 989e12        # bf16 per card
HBM_BW = 3.35e12           # bytes/s per card
NVLINK_LINK_BW = 25e9      # bytes/s per link, each way
NVLINK_LINKS = 18          # links per card

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
#: ``_c10d_functional`` op -> the reference's kind name (XLA's HLO names;
#: no functional op is a collective-permute, which stays 0)
_KINDS = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def collective_kind(func) -> str | None:
    """The kind name of a ``_c10d_functional`` op, else None."""
    if getattr(func, "namespace", None) != "_c10d_functional":
        return None
    return _KINDS.get(func._overloadpacket.__name__)


def record_collective(records: list, func, args, kwargs, out) -> None:
    """Append (kind, max(result, operand) bytes) for a collective op."""
    kind = collective_kind(func)
    if kind is not None:
        records.append((kind, max(_nbytes(out), _nbytes((args, kwargs)))))


class CollectiveRecorder(TorchDispatchMode):
    """Records every collective on local tensors while active: an op on
    ``DTensor``s is let through (``NotImplemented``) so the mode sees
    the collectives DTensor issues for it.  ``records`` holds (kind,
    bytes) pairs; bytes are per rank."""

    def __init__(self):
        super().__init__()
        self.records: list = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        record_collective(self.records, func, args, kwargs, out)
        return out


def collective_bytes(records) -> dict:
    """Per-kind max(result, operand) bytes summed over instances, from
    the (kind, bytes) pairs a :class:`CollectiveRecorder` (or the
    dry-run's meter) took; bytes are per rank."""
    out = {k: 0 for k in COLLECTIVES}
    counts = {k: 0 for k in COLLECTIVES}
    for kind, n in records:
        out[kind] += n
        counts[kind] += 1
    return {"bytes_by_kind": {k: v for k, v in out.items() if v},
            "counts": {k: v for k, v in counts.items() if v},
            "total_bytes": sum(out.values())}


@dataclasses.dataclass
class Roofline:
    flops: float               # per device
    hbm_bytes: float           # per device
    coll_bytes: float          # per device
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    model_flops_total: float   # 6ND-style whole-step useful FLOPs
    useful_ratio: float        # model_flops / (flops * n_devices)

    def as_dict(self):
        return dataclasses.asdict(self)


def analyze(cost: dict, colls: dict, n_devices: int,
            model_flops_total: float,
            coll_bytes_override: float | None = None) -> Roofline:
    """The three terms of one rank's ``cost`` (``flops``, ``bytes
    accessed``) and collectives ``colls`` (:func:`collective_bytes`)
    at the H100's rates."""
    flops = float(cost.get("flops", 0.0))
    hbm = float(cost.get("bytes accessed", 0.0))
    coll = float(colls["total_bytes"] if coll_bytes_override is None
                 else coll_bytes_override)
    t_c = flops / PEAK_FLOPS
    t_m = hbm / HBM_BW
    t_x = coll / (NVLINK_LINKS * NVLINK_LINK_BW)
    terms = {"compute": t_c, "memory": t_m, "collective": t_x}
    bn = max(terms, key=terms.get)
    useful = model_flops_total / max(flops * n_devices, 1.0)
    return Roofline(flops=flops, hbm_bytes=hbm, coll_bytes=coll,
                    t_compute=t_c, t_memory=t_m, t_collective=t_x,
                    bottleneck=bn, model_flops_total=model_flops_total,
                    useful_ratio=useful)


def model_flops(cfg, shape_kind: str, seq: int, batch: int) -> float:
    """6*N_active*D for training, 2*N_active*D for inference forward;
    decode counts one token per sequence in the batch."""
    n = cfg.active_param_count()
    if shape_kind == "train":
        return 6.0 * n * seq * batch
    if shape_kind == "prefill":
        return 2.0 * n * seq * batch
    return 2.0 * n * batch      # decode: one token per sequence


# ---------------------------------------------------------------------------
# Limb-op roofline for the encrypted ADMM stack (RunReports)
# ---------------------------------------------------------------------------

LIMB_BITS = 16                 # the public limb width (core/bigint.py)
#: Peak 16-bit limb products per second of one H100 SXM at 700 W.  The
#: 32-bit integer multiply-add pipe has 64 lanes per SM on compute
#: capability 9.0 (CUDA C++ Programming Guide, arithmetic instruction
#: throughput), a quarter of the 128 fp32 lanes behind 67 TFLOP/s (NVIDIA
#: H100 data sheet): 67e12 / 4 = 16.75e12 IMAD results per second, the
#: figure the kernels' bounds use.  A 32x32 -> 64-bit word product takes
#: two IMAD results (low and high word) and covers four 16x16-bit limb
#: products, so the peak is 16.75e12 / 2 * 4 = 3.35e13 limb products/s.
IMAD_PER_S = 67e12 / 4
PEAK_LIMB_MULS_PER_S = IMAD_PER_S / 2 * 4
GAMMA2_EXP_BITS = 20           # typical Gamma_2 exponent width (~log2 Delta)


def _active_method() -> str:
    return os.environ.get("REPRO_MODEXP_METHOD", "win4")


def _active_reduce_impl() -> str:
    return os.environ.get("REPRO_REDUCE_IMPL", "montgomery")


def ladder_mulmods(method: str, exp_bits: int,
                   reduce_impl: str = "barrett") -> float:
    """Executed mulmods for one ModExp under the active ladder schedule.

    * ``binary`` — the constant-time ladder executes BOTH the squaring and
      the selected multiply every bit: ``2/bit``;
    * ``win4`` — 4 squarings + 1 oblivious table select per 4-bit window
      plus the 15-mulmod power table: ``1.25/bit + 15``;
    * ``fixed`` — the batch-shared host-known-exponent ladder
      (``ops.modexp_fixed``): the win4 schedule over the exponent's TRUE
      bit-length.

    ``reduce_impl="montgomery"`` adds the 2 domain enter/leave
    REDC-equivalents.
    """
    if method == "binary":
        n = 2.0 * exp_bits
    elif method in ("win4", "fixed"):
        n = 1.25 * exp_bits + 15.0 if exp_bits > 0 else 0.0
    else:
        raise ValueError(f"unknown modexp method {method!r}")
    if reduce_impl == "montgomery" and n > 0:
        n += 2.0
    return n


def limb_ops(ops: dict, key_bits: int,
             exp_bits: int = GAMMA2_EXP_BITS,
             method: str | None = None,
             reduce_impl: str | None = None) -> dict:
    """16-bit limb-multiplications implied by an OpCounter ``ops`` dict.

    ``ops`` is the RunReport ``"ops"`` section: ``{phase: {op: count}}``.
    Ciphertexts live mod n^2, i.e. ``L = ceil(2*key_bits / 16)`` limbs.
    Schoolbook costs per op, priced by the active ladder schedule
    (``method`` defaults to ``$REPRO_MODEXP_METHOD``/win4 and
    ``reduce_impl`` to ``$REPRO_REDUCE_IMPL``/montgomery, as
    ``kernels/ops.py`` resolves them):

    * ``mulmod``  — one LxL product: ``L^2``;
    * ``modexp``  — :func:`ladder_mulmods`(method, exp_bits) ``* L^2``;
    * ``enc``/``dec`` — one full-width exponentiation with a key-constant
      exponent: :func:`ladder_mulmods`("fixed", key_bits) ``* L^2``.
    """
    method = method or _active_method()
    reduce_impl = reduce_impl or _active_reduce_impl()
    L = max(1, -(-2 * key_bits // LIMB_BITS))
    totals: dict[str, int] = {}
    for per_phase in ops.values():
        for op, n in per_phase.items():
            totals[op] = totals.get(op, 0) + int(n)
    key_exp = ladder_mulmods("fixed", key_bits, reduce_impl)
    per_op = {
        "modexp": ladder_mulmods(method, exp_bits, reduce_impl) * L * L,
        "mulmod": float(L * L),
        "enc": key_exp * L * L,
        "dec": key_exp * L * L,
    }
    by_op = {op: totals.get(op, 0) * per_op[op]
             for op in per_op if totals.get(op)}
    return {"key_bits": key_bits, "limbs": L, "exp_bits": exp_bits,
            "method": method, "reduce_impl": reduce_impl,
            "by_op": by_op, "limb_muls": sum(by_op.values())}


def achieved_vs_peak(ops: dict, key_bits: int, seconds: float,
                     peak: float = PEAK_LIMB_MULS_PER_S,
                     exp_bits: int = GAMMA2_EXP_BITS,
                     method: str | None = None,
                     reduce_impl: str | None = None) -> dict:
    """Achieved limb-mul rate over ``seconds`` vs the card's peak.

    ``seconds`` may be wall or virtual time: a RunReport built on the
    simulated clock reports utilization of the modeled device.
    """
    lo = limb_ops(ops, key_bits, exp_bits=exp_bits, method=method,
                  reduce_impl=reduce_impl)
    rate = lo["limb_muls"] / seconds if seconds > 0 else 0.0
    lo.update(seconds=seconds, peak_limb_muls_per_s=peak,
              limb_muls_per_s=rate,
              fraction_of_peak=rate / peak if peak > 0 else 0.0)
    return lo
