#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It imports only ``repro_torch`` (from ``src/``), never JAX or the JAX
package, and:

1. requires a CUDA card and prints its name and power limit;
2. builds the three hand-written kernels from ``src/repro_torch/kernels/
   csrc`` (one ``nvcc`` per source, in parallel) and prints the build time
   and each kernel's registers and stack;
3. holds every kernel instantiation (mulmod; modexp's four bodies;
   modexp_fixed's two) against its plain PyTorch version on the card and
   against Python ints, at the main path's widths (2048-bit p^2/q^2,
   4096-bit n^2), an odd-byte 1000-bit width with full-width operands,
   and batches {0, 1, ragged}; then, at the main path's own (large)
   batches, times each instantiation with CUDA events beside its plain
   version on the same inputs and holds the two outputs against each
   other and against Python ints on a sample;
4. runs the main path — gold-cipher private LASSO at the paper's Fig. 6
   key and quantizer (2048-bit keys, Delta = 1e15, K = 3, rho = lam = 1)
   with the scale cut to N = 576, M = 64, 3 iterations — and the plain
   arm on the same instance; the histories must be equal bit for bit, a
   sample of the first round's ciphertexts must equal the scalar
   ``encrypt_crt`` on a replayed rng, and every kernel must have been
   launched during the gold run;
5. prints the kernel table as one JSON line, then as its last line
   ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and prints no
result.  Exact integer work: the tolerance of every comparison is zero.
"""
import json
import os
import random
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))

# Main-path scale (Fig. 6 of the paper, N and M cut to fit the time limit)
KEY_BITS, DELTA, K, RHO, LAM = 2048, 1e15, 3, 1.0, 1.0
N, M, ITERS, SEED = 576, 64, 3, 0
NK = N // K

# H100 SXM peaks (NVIDIA data sheet): HBM 3.35 TB/s; fp32 67 TFLOP/s
# counts 2 flops per FMA on 128 FMA lanes per SM, and the 32-bit integer
# multiply-add pipe has 64 lanes per SM on compute capability 9.0 (CUDA C++
# Programming Guide, arithmetic instruction throughput), so 32-bit IMAD
# results peak at 67e12 / 4 per second.  A 32x32->64-bit word product is
# two IMAD results (low and high word).
HBM_BYTES_PER_S = 3.35e12
IMAD_PER_S = 67e12 / 4

REPLACES = {
    "mulmod": "src/repro/kernels/limb_mulmod.py:41",
    "modexp": "src/repro/kernels/modexp.py:85",
    "modexp_fixed": "src/repro/kernels/modexp.py:133",
}


def log(*parts):
    print(*parts, flush=True)


def require_card():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    log(smi.stdout.strip())


# ---------------------------------------------------------------------------
# work and bound of one launch
# ---------------------------------------------------------------------------

def _product(k, square):
    """Word products of a k-word product; a squaring needs only the
    k(k+1)/2 distinct pairs (HAC 14.16)."""
    return k * (k + 1) // 2 if square else k * k


def _redc(k):
    return k * k + k                           # u = t*mp per word, u*m


def _barrett(k):
    # the upper k+1 words of q1*mu (pairs i+j >= k-1, HAC 14.42 note) and
    # the low k+1 words of q3*m
    return (k + 1) ** 2 - k * (k - 1) // 2 + k + k * (k + 1) // 2


def word_products(kernel, k, exp_bits=0, mont=True, win4=True):
    """Least 32x32-bit word products one element of a launch needs, by
    the kernel's ladder with the squaring saving taken."""
    if kernel == "mulmod":
        return _product(k, False) + _barrett(k)
    if win4:                                   # 4-bit windows; fixed too
        squares, others = exp_bits, exp_bits // 4 + 14
    else:                                      # binary: res*b, b*b per bit
        squares, others = exp_bits, exp_bits
    red = _redc(k) if mont else _barrett(k)
    work = squares * (_product(k, True) + red) \
        + others * (_product(k, False) + red)
    if mont:                                   # enter (times r2), leave
        return work + _product(k, False) + 2 * red
    return work + red                          # enter: reduce the base


def bound_ms(products_per_el, B, bytes_moved):
    ops_s = 2 * products_per_el * B / IMAD_PER_S
    bytes_s = bytes_moved / HBM_BYTES_PER_S
    return 1e3 * max(ops_s, bytes_s), \
        "operations" if ops_s >= bytes_s else "bytes"


def time_ms(fn, reps):
    """Milliseconds per call of ``fn`` after a warm-up call, and the
    warm-up call's result."""
    result = fn()                              # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps, result


def compare(bi, name, got, plain, want_ints):
    """Kernel output == plain output (zero tolerance) and == Python ints
    on the sample ``want_ints``; returns the max absolute limb error."""
    torch.cuda.synchronize()
    err = int((got.long() - plain.long()).abs().max()) if got.numel() else 0
    assert got.shape == plain.shape and err == 0, (name, err)
    assert bi.to_ints(got[:len(want_ints)]) == want_ints, name
    return err


# ---------------------------------------------------------------------------
# kernels vs plain versions
# ---------------------------------------------------------------------------

def check_kernels(key, bi, ops, mg, lm, mx, dev):
    """Every instantiation against its plain version and Python ints at
    small batches; :func:`time_kernels` adds the main path's batches."""
    rng = random.Random(SEED + 1)
    odd1000 = rng.getrandbits(1000) | (1 << 999) | 1   # 125 bytes: odd
    packs = {"n2": ops.pack_modulus(key.n2), "p2": ops.pack_modulus(key.p2),
             "q2": ops.pack_modulus(key.q2),
             "odd1000": ops.pack_modulus(odd1000)}

    def rows(B, L):
        ints = [rng.getrandbits(16 * L) for _ in range(B)]
        return ints, torch.as_tensor(bi.from_ints(ints, L), device=dev)

    for width, B in (("n2", 0), ("n2", 1), ("n2", 77), ("p2", 77),
                     ("q2", 77), ("odd1000", 77)):
        pack = packs[width]
        dm = pack.on(dev)
        a, at = rows(B, pack.L16)
        b, bt = rows(B, pack.L16)
        compare(bi, "mulmod", lm.mulmod_cuda(at, bt, dm),
                lm.mulmod_plain(at, bt, dm),
                [(x * y) % pack.m_int for x, y in zip(a[:4], b[:4])])
        log(f"  mulmod {width} B={B}: equal")

    lam_p = key.lam % key.phi_p2
    for impl in ("montgomery", "barrett"):
        for method in ("win4", "binary"):
            name = f"modexp[{impl},{method}]"
            for width, B in (("p2", 0), ("p2", 1), ("p2", 77), ("q2", 77),
                             ("odd1000", 77)):
                pack = packs[width]
                dm = pack.on(dev)
                base, bt = rows(B, pack.L16)
                exps, et = rows(B, 4)
                if B:
                    exps[0] = 0
                    et[0] = 0
                compare(bi, name, mx.modexp_cuda(bt, et, dm, method, impl),
                        mx.modexp_plain(bt, et, dm, method, impl),
                        [pow(x, e, pack.m_int)
                         for x, e in zip(base[:4], exps[:4])])
            log(f"  {name}: equal")
        name = f"modexp_fixed[{impl}]"
        for width, B, e in (("p2", 0, lam_p), ("p2", 1, lam_p),
                            ("p2", 77, lam_p),
                            ("q2", 77, key.lam % key.phi_q2),
                            ("odd1000", 77, rng.getrandbits(1000))):
            pack = packs[width]
            dm = pack.on(dev)
            base, bt = rows(B, pack.L16)
            win = mg.exp_windows(e)
            compare(bi, name, mx.modexp_fixed_cuda(bt, win, dm, impl),
                    mx.modexp_fixed_plain(bt, win, dm, impl),
                    [pow(x, e, pack.m_int) for x in base[:4]])
        log(f"  {name}: equal")
    return packs


def time_kernels(key, packs, bi, mg, lm, mx, dev):
    """Each instantiation at the main path's shapes: timed beside its
    plain version on the same inputs, and both outputs held against each
    other (zero tolerance) and against Python ints on a sample."""
    rng = random.Random(SEED + 2)
    out = {}

    def rows(B, L):
        ints = [rng.getrandbits(16 * L) for _ in range(B)]
        return ints, torch.as_tensor(bi.from_ints(ints, L), device=dev)

    def measure(name, kernel, plain, reps, want, shape, products, B,
                nbytes):
        ms, got = time_ms(kernel, reps)
        plain_ms, ref = time_ms(plain, 1)
        bnd, by = bound_ms(products, B, nbytes)
        out[name] = dict(shape=shape, ms=ms, plain_ms=plain_ms,
                         max_abs_err=compare(bi, name, got, ref, want),
                         bound_ms=bnd, bound_by=by)
        log(f"  {name} {shape}: {ms:.3f} ms (plain {plain_ms:.1f} ms), "
            f"equal")

    # mulmod: the first level of the n^2 product tree, Nk^2 / 2 rows
    pack = packs["n2"]
    dm = pack.on(dev)
    B = NK * NK // 2
    (a, at), (b, bt) = rows(B, pack.L16), rows(B, pack.L16)
    measure("mulmod", lambda: lm.mulmod_cuda(at, bt, dm),
            lambda: lm.mulmod_plain(at, bt, dm), 10,
            [(x * y) % pack.m_int for x, y in zip(a[:4], b[:4])],
            f"B={B} n^2 {pack.L32} words",
            word_products("mulmod", pack.L32), B, 3 * B * pack.L16 * 4)
    # modexp: one edge's matvec in one half space, Nk^2 elements, 4-limb
    # (64-bit) exponents as Gamma_2 codes of Delta = 1e15 need
    pack = packs["p2"]
    dm = pack.on(dev)
    B = NK * NK
    (base, bt), (exps, et) = rows(B, pack.L16), rows(B, 4)
    want = [pow(x, e, pack.m_int) for x, e in zip(base[:4], exps[:4])]
    for impl in ("montgomery", "barrett"):
        for method in ("win4", "binary"):
            measure(f"modexp[{impl},{method}]",
                    lambda: mx.modexp_cuda(bt, et, dm, method, impl),
                    lambda: mx.modexp_plain(bt, et, dm, method, impl), 5,
                    want, f"B={B} p^2 {pack.L32} words, 64-bit exps",
                    word_products("modexp", pack.L32, exp_bits=64,
                                  mont=impl == "montgomery",
                                  win4=method == "win4"),
                    B, B * (2 * pack.L16 + 4) * 4)
    # modexp_fixed: one encryption's r^n / decryption's c^lam half, Nk rows
    B = NK
    base, bt = rows(B, pack.L16)
    e = key.lam % key.phi_p2
    win = mg.exp_windows(e)
    want = [pow(x, e, pack.m_int) for x in base[:4]]
    for impl in ("montgomery", "barrett"):
        measure(f"modexp_fixed[{impl}]",
                lambda: mx.modexp_fixed_cuda(bt, win, dm, impl),
                lambda: mx.modexp_fixed_plain(bt, win, dm, impl), 3, want,
                f"B={B} p^2 {pack.L32} words, {len(win)} windows",
                word_products("modexp_fixed", pack.L32,
                              exp_bits=4 * len(win),
                              mont=impl == "montgomery"),
                B, 2 * B * pack.L16 * 4 + 4 * len(win))
    return out


# ---------------------------------------------------------------------------
# main path
# ---------------------------------------------------------------------------

class RecordingBox:
    """Keeps each encryption's plaintexts and (resident) ciphertexts."""

    def __init__(self, box):
        self._box = box
        self.calls = []

    def __getattr__(self, attr):
        return getattr(self._box, attr)

    def encrypt(self, m):
        c = self._box.encrypt(m)
        self.calls.append((np.asarray(m).reshape(-1), c))
        return c


def run_main_path(protocol, gold, bi, build, QuantSpec, make_lasso):
    inst = make_lasso(M, N, sparsity=0.1, noise=0.01, seed=SEED)
    spec = QuantSpec(delta=DELTA, zmin=-16.0, zmax=16.0)
    cfg = protocol.ProtocolConfig(K=K, rho=RHO, lam=LAM, iters=ITERS,
                                  spec=spec, cipher="gold",
                                  key_bits=KEY_BITS, seed=SEED,
                                  device="cuda")
    rec = {}
    real_make_box = protocol.make_box

    def recording_make_box(*a, **kw):
        box, key = real_make_box(*a, **kw)
        rec["box"] = RecordingBox(box)
        return rec["box"], key

    protocol.make_box = recording_make_box
    try:
        build.reset_launches()
        t0 = time.perf_counter()
        gold_res = protocol.run_protocol(inst.A, inst.y, cfg)
        wall = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
    finally:
        protocol.make_box = real_make_box
    plain_res = protocol.run_protocol(
        inst.A, inst.y, protocol.ProtocolConfig(
            K=K, rho=RHO, lam=LAM, iters=ITERS, spec=spec, cipher="plain",
            seed=SEED, device="cuda"))
    assert gold_res.history.shape == (ITERS, N)
    assert np.all(np.isfinite(gold_res.history))
    assert gold_res.history.tobytes() == plain_res.history.tobytes(), \
        "gold history differs from the plain arm"
    for name, n in launches.items():
        assert n > 0, f"kernel {name} was not launched on the main path"
    # replay the blinding rng: the share phase's K encryptions, then the
    # first round's (z, v) pair per edge; sample each call's first rows
    box = rec["box"]
    rng = random.Random(SEED)
    key = gold.keygen(KEY_BITS, rng)
    assert key == box.key
    checked = 0
    for idx, (ms, c) in enumerate(box.calls[:3 * K]):
        rs = [gold.rand_r(key, rng) for _ in ms]
        if idx >= K:                           # the first round's calls
            got = bi.to_ints(c.limbs[:4])
            want = [gold.encrypt_crt(key, int(m), r)
                    for m, r in zip(ms[:4], rs[:4])]
            assert got == want, f"ciphertext mismatch in call {idx}"
            checked += len(got)
    return gold_res, wall, launches, checked


def main():
    require_card()
    sys.path.insert(0, os.path.join(REPO, "src"))
    from repro_torch.core import bigint as bi
    from repro_torch.core import paillier as gold
    from repro_torch.core import protocol
    from repro_torch.core.quantization import QuantSpec
    from repro_torch.data.synthetic import make_lasso
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import limb_mulmod as lm
    from repro_torch.kernels import modexp as mx
    from repro_torch.kernels import montgomery as mg
    dev = torch.device("cuda")

    t0 = time.perf_counter()
    logs = build.build_all(ptxas_verbose=True)
    log(f"build: {time.perf_counter() - t0:.2f} s ({len(logs)} kernels "
        f"compiled)")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "stack frame" in line:
                log(f"  {name}: {line.strip()}")

    key = gold.keygen(KEY_BITS, random.Random(SEED))
    log("kernels vs plain versions on the card:")
    packs = check_kernels(key, bi, ops, mg, lm, mx, dev)
    log("kernels vs plain versions at main-path shapes, timed:")
    times = time_kernels(key, packs, bi, mg, lm, mx, dev)

    log(f"main path: gold LASSO, {KEY_BITS}-bit key, Delta={DELTA:g}, "
        f"K={K}, N={N}, M={M}, iters={ITERS}")
    res, wall, launches, checked = run_main_path(
        protocol, gold, bi, build, QuantSpec, make_lasso)
    secs = res.stats["seconds"]
    log(f"  wall {wall:.2f} s; init {secs['init']:.3f} s, share "
        f"{secs['share']:.3f} s, iterate {secs['iterate']:.3f} s; rounds "
        + ", ".join(f"{s:.3f}" for s in secs["rounds"]) + " s")
    log(f"  history equals the plain arm bit for bit; {checked} sampled "
        f"ciphertexts equal scalar encrypt_crt; launches {launches}")
    log("variants: " + json.dumps(
        {k: v for k, v in times.items()
         if k not in ("mulmod", "modexp[montgomery,win4]",
                      "modexp_fixed[montgomery]")}))

    kernels = []
    for name, timed in (("mulmod", "mulmod"),
                        ("modexp", "modexp[montgomery,win4]"),
                        ("modexp_fixed", "modexp_fixed[montgomery]")):
        t = times[timed]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None,
            "shape": t["shape"]})
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
