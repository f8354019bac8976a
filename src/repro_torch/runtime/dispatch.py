"""Adaptive cipher-backend dispatch, ported from ``repro.runtime.dispatch``.

At startup :func:`calibrate` measures per-element seconds for each crypto
op (enc / add / matvec / dec) on every requested backend over a
``key_bits x batch_size`` grid, on one device, and persists the table as
JSON (default ``~/.cache/repro_torch/dispatch_calib.json``, override with
``$REPRO_CALIB_CACHE``).  Entries are keyed by the device kind that
measured them (``torch-cpu/gold/128/16``, ``torch-cuda-NVIDIA H100 80GB
HBM3/vec/2048/192`` — see :func:`device_kind`), so one cache file holds
separate grids and numbers from one device never price another's
routing; the kinds never collide with the JAX package's (``cpu``, ``gpu``,
``tpu``), so the port never reads the reference's entries.  Subsequent
runs on the same device load the cache and skip the measurement.

:class:`AdaptiveBox` then implements the protocol's cipher-box interface
and routes *each call* to the cheapest backend.  ``gold`` (scalar
Python-int Paillier), ``gold_batch`` (the batched CRT fast path on the
device — identical ciphertexts, so switching between the two golds is
free) and ``vec`` (limb kernels at n^2) share one key and one ciphertext
space, so a per-op switch is at most a representation change (ints <->
limb tensors) whose cost is part of the routing decision.  ``plain`` is
calibrated too — it prices the functional-simulation path for the cost
model — but is never mixed into an encrypted run.

:class:`CostModel` turns calibration entries (or analytic defaults) into
virtual-clock charges for the scheduler.

Timing: kernels run asynchronously, so on a CUDA device every clock read
of :func:`_median_seconds` follows a ``torch.cuda.synchronize`` — without
it the table would hold enqueue times and the card's backends would look
free.
"""
from __future__ import annotations

import json
import os
import random
import time
from collections import Counter

import numpy as np
import torch

from .. import resolve_device
from ..core import bigint as bi
from ..core import cipher_tensor as ct_mod
from ..core import paillier as gold
from ..core import paillier_batch as pb
from ..core.quantization import QuantSpec
from ..obs import trace as trace_mod
from ..obs.metrics import record_profile

TABLE_VERSION = 3   # the reference's table format (device-keyed entries)
OPS = ("enc", "add", "matvec", "dec")
DEFAULT_BACKENDS = ("plain", "gold", "gold_batch", "vec")
# which ciphertext representation each routable backend produces/consumes
# (scalar and batched gold share the Python-int representation, so routing
# between them is free of conversion cost)
BACKEND_REP = {"gold": "gold", "gold_batch": "gold", "vec": "vec"}


def cache_path() -> str:
    return os.path.expanduser(
        os.environ.get("REPRO_CALIB_CACHE",
                       "~/.cache/repro_torch/dispatch_calib.json"))


def device_kind(device=None) -> str:
    """Calibration-cache device key of ``device`` (default the card):
    ``torch-cpu``, or ``torch-cuda-<card name>`` with any ``/`` replaced.

    Throughput tables are device-specific — the limb kernels that lose to
    Python-int pow on a CPU win on a card — so entries measured on one
    device kind must never price another's dispatch decisions.

    A box of N > 1 cards gets an ``xN`` suffix (``torch-cuda-<card>x4``),
    as the reference's multi-chip hosts do: the batched ops split their
    leading axis over the cards (``launch.mesh.kernel_mesh``), so measured
    throughput scales with the card count and an N-card table must not
    price a one-card box.
    """
    from ..launch.mesh import kernel_mesh
    dev = resolve_device(device)
    kind = "torch-cpu" if dev.type == "cpu" else "torch-cuda-" \
        + torch.cuda.get_device_name(dev).replace("/", "-")
    cards = kernel_mesh(dev)
    return f"{kind}x{len(cards)}" if cards else kind


def _entry_key(backend: str, key_bits: int, batch: int, kind: str) -> str:
    return f"{kind}/{backend}/{key_bits}/{batch}"


#: a warm-up call at least this long is timed once more, not ``reps`` times
LONG_CALL_S = 1.0


def _median_seconds(fn, device: torch.device, reps: int = 3) -> float:
    """Median seconds of ``fn`` over ``reps`` calls after a warm-up call;
    on a CUDA device the clock is read only after the device has
    finished.  A call whose warm-up took :data:`LONG_CALL_S` or more (the
    scalar Python-int backend at 2048 bits: ten seconds an op over a
    batch of 192) is timed once: its per-call noise is far below the gaps
    the routing compares, and three more calls would make calibration
    minutes long."""
    def timed() -> float:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter() - t0

    first = timed()  # warm-up (kernel build and load, caches)
    n = 1 if first >= LONG_CALL_S else reps
    return float(np.median([timed() for _ in range(n)]))


def _measure_backend(backend: str, key_bits: int, batch: int,
                     mat_rows: int, seed: int,
                     device: torch.device) -> dict:
    """Per-element seconds for one grid point (built fresh, no cache)."""
    from ..core import protocol  # deferred: protocol lazily imports us back

    rng = random.Random(seed)
    spec = QuantSpec(delta=1e6, zmin=-8.0, zmax=8.0)
    m = np.arange(batch, dtype=np.int64) % 1000
    # exponents must look like real Gamma_2 values (~20 bits): pow() with
    # trivial exponents short-circuits and underestimates gold's matvec
    K = np.array([rng.randrange(1, 1 << 20)
                  for _ in range(mat_rows * batch)],
                 dtype=np.int64).reshape(mat_rows, batch)
    if backend == "plain":
        box = protocol.PlainBox(spec, batch)
    else:
        key = gold.keygen(key_bits, rng)
        if backend == "gold":
            box = protocol.GoldBox(key, rng, batch=False,   # scalar loops
                                   device=device)
        elif backend == "gold_batch":
            # batch_min=1 mirrors AdaptiveBox's gold_batch box: the table
            # must price the kernel path even at sub-8 batch grid points
            box = protocol.GoldBox(key, rng, batch=True, batch_min=1,
                                   device=device)
        elif backend == "vec":
            # price the common case: chains that fit int64
            box = protocol.VecBox(key, rng, plain_bits=48, device=device)
        else:
            raise ValueError(backend)
    c = box.encrypt(m)
    sec = lambda fn: _median_seconds(fn, device)   # noqa: E731
    out = {
        "enc": sec(lambda: box.encrypt(m)) / batch,
        "add": sec(lambda: box.add(c, c)) / batch,
        "matvec": sec(lambda: box.matvec(K, c)) / (mat_rows * batch),
        "dec": sec(lambda: box.decrypt(c)) / batch,
    }
    convert = 0.0
    if backend in ("gold", "gold_batch"):
        # cost to lift this representation into the vec limb space; a
        # limb-resident CipherTensor (the batched gold output) is already
        # there, so its conversion is free by construction
        if not isinstance(c, ct_mod.CipherTensor):
            L16 = (key.n2.bit_length() + 15) // 16
            convert = sec(lambda: torch.as_tensor(
                bi.from_ints(c, L16), device=device)) / batch
    elif backend == "vec":
        convert = sec(lambda: bi.to_ints(c)) / batch
    out["convert"] = convert
    return out


def _load_table(path: str) -> dict | None:
    """The table at ``path``, or ``None`` when it is missing, unreadable,
    of another version or ill-typed."""
    try:
        with open(path) as f:
            loaded = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    if (isinstance(loaded, dict)
            and loaded.get("version") == TABLE_VERSION
            and isinstance(loaded.get("entries"), dict)
            and all(isinstance(v, dict)
                    for v in loaded["entries"].values())):
        return loaded
    return None


def _write_table(table: dict, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(table, f, indent=1, sort_keys=True)
    os.replace(tmp, path)


def calibrate(key_bits=(128,), batch_sizes=(8, 64),
              backends=DEFAULT_BACKENDS, path: str | None = None,
              force: bool = False, mat_rows: int = 8, seed: int = 0,
              warm_key: "gold.PaillierKey | None" = None,
              warm_shapes=None, device=None) -> dict:
    """Fill (and persist) the throughput table for the requested grid on
    ``device`` (default the card).

    Only missing grid points are measured; everything already in the
    on-disk cache under this device's kind is reused, so the second run
    of any entry point starts instantly.  A corrupted or partial cache
    file (truncated JSON, wrong top-level type, missing/ill-typed
    ``entries``, version skew) never crashes the load — it falls back to
    measuring fresh and rewrites the file.

    ``warm_key`` additionally runs the batched ops for that key once via
    :func:`paillier_batch.warmup` (the kernels are built and loaded before
    the run, even on a cache hit).  ``warm_shapes`` defaults to
    ``batch_sizes`` (ints warm enc/dec/⊕; ``(B, M, N)`` tuples warm the
    fused matvec).
    """
    from ..kernels import compile_cache
    dev = resolve_device(device)
    kind = device_kind(dev)
    compile_cache.enable()
    path = path or cache_path()
    table = None if force else _load_table(path)
    if table is None:
        table = {"version": TABLE_VERSION, "entries": {}}
    dirty = False
    t0 = time.perf_counter()
    n_measured = n_cached = 0
    for backend in backends:
        for bits in key_bits:
            b = 0 if backend == "plain" else bits
            for batch in batch_sizes:
                k = _entry_key(backend, b, batch, kind)
                if k not in table["entries"]:
                    table["entries"][k] = _measure_backend(
                        backend, b, batch, mat_rows, seed, dev)
                    dirty = True
                    n_measured += 1
                else:
                    n_cached += 1
    record_profile("calibrate", measured=n_measured, cached=n_cached,
                   seconds=time.perf_counter() - t0, device=kind)
    if dirty:
        _write_table(table, path)
    if warm_key is not None:
        shapes = list(warm_shapes) if warm_shapes is not None \
            else list(batch_sizes)
        pb.warmup(pb.make_batch_key(warm_key, dev), shapes)
    return table


def lookup(table: dict, backend: str, key_bits: int, batch: int,
           kind: str | None = None) -> dict:
    """Nearest grid entry for ``backend`` on device kind ``kind`` (default
    the card's): closest key bits, then closest batch (plain entries are
    stored under 0 bits and match any key).  Entries keyed
    ``kind/backend/bits/batch`` only match their own kind; 3-part keys act
    as device wildcards (hand-built tables)."""
    kind = kind or device_kind()
    bits = 0 if backend == "plain" else key_bits
    best, best_d = None, None
    for k, v in table.get("entries", {}).items():
        parts = k.split("/")
        if len(parts) == 4:
            dev, b, kb, bt = parts
            if dev != kind:
                continue
        else:
            b, kb, bt = parts
        if b != backend:
            continue
        d = (abs(int(kb) - bits), abs(int(bt) - batch))
        if best_d is None or d < best_d:
            best, best_d = v, d
    if best is None:
        raise KeyError(f"no calibration for {backend!r} on {kind!r} "
                       f"(run dispatch.calibrate first)")
    return best


# ---------------------------------------------------------------------------
# Serving admission knee cache
# ---------------------------------------------------------------------------
# A multi-tenant engine tunes how many tenants to admit concurrently (the
# knee of the aggregate rounds/sec curve) and persists the result here.
# Entries share the dispatch cache file under the backend name "serve"
# (``<kind>/serve/<key_bits>/<nk>``): :func:`lookup` filters on backend
# before parsing, and the load validation only requires dict values, so
# the two families coexist.

def _serve_key(key_bits: int, nk: int, kind: str) -> str:
    return _entry_key("serve", key_bits, nk, kind)


def save_serve_knee(key_bits: int, nk: int, window: int,
                    curve: dict | None = None, path: str | None = None,
                    kind: str | None = None) -> None:
    """Persist the tuned admission window for ``(kind, key_bits, nk)``
    (``kind`` defaults to the card's).

    ``curve`` optionally records the measured width -> rounds/sec sweep.
    The write is atomic (tmp + rename), merging into whatever calibration
    entries already live in the file; a corrupt existing file is replaced.
    """
    kind = kind or device_kind()
    path = path or cache_path()
    table = _load_table(path) if os.path.exists(path) else None
    if table is None:
        table = {"version": TABLE_VERSION, "entries": {}}
    entry: dict = {"window": int(window)}
    if curve is not None:
        entry["rounds_per_sec"] = {str(k): float(v)
                                   for k, v in curve.items()}
    table["entries"][_serve_key(key_bits, nk, kind)] = entry
    _write_table(table, path)


def load_serve_knee(key_bits: int, nk: int, path: str | None = None,
                    kind: str | None = None) -> int | None:
    """Tuned admission window for ``(kind, key_bits, nk)``, or ``None`` on
    any defect — missing file, unreadable JSON, version skew, absent
    entry, non-dict entry, missing/non-positive/ill-typed window."""
    kind = kind or device_kind()
    path = path or cache_path()
    try:
        with open(path) as f:
            loaded = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    if not (isinstance(loaded, dict)
            and loaded.get("version") == TABLE_VERSION
            and isinstance(loaded.get("entries"), dict)):
        return None
    entry = loaded["entries"].get(_serve_key(key_bits, nk, kind))
    if not isinstance(entry, dict):
        return None
    window = entry.get("window")
    if not isinstance(window, int) or isinstance(window, bool) \
            or window < 1:
        return None
    return window


# ---------------------------------------------------------------------------
# Virtual-clock cost model
# ---------------------------------------------------------------------------

# analytic fallback (seconds/op) in OpCounter vocabulary; roughly a small
# edge CPU on a 1024-bit key — only relative magnitudes matter for the
# simulated wall-clock.
DEFAULT_UNIT = {"enc": 2e-4, "dec": 2e-4, "modexp": 1e-4, "mulmod": 1e-7}


class CostModel:
    """Seconds charged to the virtual clock per OpCounter-style op dict."""

    def __init__(self, unit: dict | None = None):
        self.unit = dict(DEFAULT_UNIT, **(unit or {}))

    @classmethod
    def from_table(cls, table: dict, backend: str, key_bits: int,
                   batch: int, kind: str | None = None) -> "CostModel":
        e = lookup(table, backend, key_bits, batch, kind=kind)
        return cls({"enc": e["enc"], "dec": e["dec"],
                    "modexp": e["matvec"], "mulmod": e["add"]})

    def cost(self, ops: dict) -> float:
        return sum(self.unit.get(op, 0.0) * n for op, n in ops.items())

    def edge_step_cost(self, n_dim: int) -> float:
        """eq. (13): one add, one (N x N) matvec, one add."""
        return self.cost({"mulmod": 2 * n_dim + n_dim * (n_dim - 1),
                          "modexp": n_dim * n_dim})


# ---------------------------------------------------------------------------
# Adaptive box
# ---------------------------------------------------------------------------

class ACipher:
    """Ciphertext vector tagged with its current representation."""

    __slots__ = ("rep", "data")

    def __init__(self, rep: str, data):
        self.rep = rep      # "gold" (list[int] | CipherTensor) | "vec" (limbs)
        self.data = data

    def __len__(self) -> int:
        return len(self.data) if self.rep == "gold" else int(self.data.shape[0])


class AdaptiveBox:
    """Protocol cipher box routing every op to the cheapest backend.

    Holds a scalar GoldBox, a batched-CRT GoldBox (``gold_batch`` — same
    key, same ciphertexts, zero conversion cost between the two) and a
    VecBox, all bumping one shared OpCounter and running their
    big-integer work on ``device`` (default the card), and consults the
    calibration table's entries for that device's kind per call; the
    per-element conversion cost is added when an operand is in the other
    representation.  Backends missing from the table (e.g. hand-built
    two-backend tables) are simply not routable.  ``choices`` records
    every routing decision for reporting.
    """

    name = "auto"

    def __init__(self, key: gold.PaillierKey, rng: random.Random,
                 table: dict, counter=None, plain_bits: int | None = None,
                 device=None):
        from ..core import protocol  # deferred: avoids import cycle
        self.device = resolve_device(device)
        self.kind = device_kind(self.device)
        self.key = key
        self.table = table
        self.gold = protocol.GoldBox(key, rng, crt=True, counter=counter,
                                     batch=False, device=self.device)
        self.counter = self.gold.counter
        self.boxes = {
            "gold": self.gold,
            "gold_batch": protocol.GoldBox(
                key, rng, crt=True, counter=self.counter, batch=True,
                batch_min=1, device=self.device),
            "vec": protocol.VecBox(key, rng, counter=self.counter,
                                   plain_bits=plain_bits,
                                   device=self.device),
        }
        self.vec = self.boxes["vec"]
        self.choices: Counter = Counter()
        # observability: the runner wires a tracer + virtual clock in so
        # every routing decision becomes a "dispatch" span
        self.tracer: "trace_mod.Tracer | trace_mod.NullTracer" = trace_mod.NULL
        self.clock = None   # callable -> virtual seconds (else wall 0.0)

    # -- routing ---------------------------------------------------------
    def _entry(self, backend: str, batch: int) -> dict:
        return lookup(self.table, backend, self.key.n.bit_length(), batch,
                      kind=self.kind)

    def _pick(self, op: str, n_el: int, reps: tuple[str, ...] = (),
              conv_el: int | None = None) -> str:
        """Cheapest backend for ``op`` over ``n_el`` elements; operands in
        another representation charge conversion on their own length
        ``conv_el`` (a matvec touches M*N exponents but converts only the
        N-element ciphertext vector)."""
        conv_el = n_el if conv_el is None else conv_el
        costs = {}
        for backend, rep_b in BACKEND_REP.items():
            try:
                c = self._entry(backend, n_el)[op] * n_el
                for rep in reps:
                    if rep != rep_b:  # operand must change representation
                        c += self._entry(rep, conv_el)["convert"] * conv_el
            except KeyError:
                continue    # backend (or its conversion) not calibrated
            costs[backend] = c
        if not costs:
            raise KeyError(f"no calibrated encrypted backend for {op!r} "
                           f"(run dispatch.calibrate first)")
        pick = min(costs, key=costs.get)
        self.choices[(op, pick)] += 1
        if self.tracer.enabled:
            self.tracer.add(f"dispatch:{op}", "dispatch",
                            t=self.clock() if self.clock else 0.0,
                            op=op, backend=pick, n_el=n_el)
        return pick

    def _coerce(self, c: ACipher, rep: str) -> object:
        if c.rep == rep:
            return c.data
        if rep == "vec":
            if isinstance(c.data, ct_mod.CipherTensor):
                return c.data.limbs        # already resident: free
            return torch.as_tensor(
                bi.from_ints(list(c.data), self.vec.vk.pack_n2.L16),
                device=self.device)
        # to "gold": wrap the vec limb tensor — the batched gold box stays
        # limb-resident and scalar consumers materialize ints lazily
        return ct_mod.CipherTensor(self.boxes["gold_batch"].batch_key(),
                                   c.data)

    def _box(self, backend: str):
        return self.boxes[backend]

    # -- box interface ---------------------------------------------------
    def encrypt(self, m: np.ndarray) -> ACipher:
        m = np.asarray(m).reshape(-1)
        b = self._pick("enc", m.size)
        return ACipher(BACKEND_REP[b], self._box(b).encrypt(m))

    def add(self, c1: ACipher, c2: ACipher) -> ACipher:
        b = self._pick("add", len(c1), reps=(c1.rep, c2.rep))
        rep = BACKEND_REP[b]
        return ACipher(rep, self._box(b).add(self._coerce(c1, rep),
                                             self._coerce(c2, rep)))

    def matvec(self, K: np.ndarray, c: ACipher) -> ACipher:
        M, N = K.shape
        b = self._pick("matvec", M * N, reps=(c.rep,), conv_el=N)
        rep = BACKEND_REP[b]
        return ACipher(rep, self._box(b).matvec(K, self._coerce(c, rep)))

    def decrypt(self, c: ACipher) -> np.ndarray:
        b = self._pick("dec", len(c), reps=(c.rep,))
        return self._box(b).decrypt(self._coerce(c, BACKEND_REP[b]))

    def ct_bytes(self, n_el: int) -> int:
        return (self.key.n2.bit_length() + 7) // 8 * n_el
