#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It imports only ``repro_torch`` (from ``src/``), never JAX or the JAX
package, and:

1. requires a CUDA card and prints its name and power limit;
2. builds the four hand-written kernel sources from ``src/repro_torch/
   kernels/csrc`` (one ``nvcc`` per source, in parallel; mulmod.cu and
   modexp.cu also hold the per-row-modulus kernels of the serving path,
   prodtree.cu the product tree of every matvec)
   and prints the build time and each instantiation's registers, stack
   frame and spills; every
   instantiation (each runs a group of threads per integer with its words
   in registers) must show no spills and a stack frame under 256 bytes;
3. holds every kernel body (mulmod; modexp's four bodies; modexp_fixed's
   two) against its plain PyTorch version on the card and against Python
   ints, at the main path's widths (2048-bit p^2/q^2, 4096-bit n^2), an
   odd-byte 1000-bit width with full-width operands, and batches {0, 1,
   ragged}; then, at the main path's own batches, times each body (its
   kernel's device time from ``torch.profiler``, and CUDA events per call,
   which also hold the wrapper's host time) beside its plain version on
   the same inputs and holds the two outputs against each other and
   against Python ints on a sample (mulmod at each of its main-path
   shapes: B = 36,864 and 192 on p^2, B = 192 on n^2); times every
   body's group-size candidates (mulmod's at each shape) on the same
   inputs and holds their outputs the same way, and times the main path's two-half modexp_fixed
   launch (p^2 and q^2 rows in one launch) against two launches;
4. runs the main path — gold-cipher private LASSO at the paper's Fig. 6
   key and quantizer (2048-bit keys, Delta = 1e15, K = 3, rho = lam = 1)
   with the scale cut to N = 576, M = 64, 3 iterations — and the plain
   arm on the same instance; the histories must be equal bit for bit, a
   sample of the first round's ciphertexts must equal the scalar
   ``encrypt_crt`` on a replayed rng, and every kernel body of the path
   must have been launched during the gold run (launches are also
   counted per batch and width);
5. splits one more main-path round by device time per kernel
   (``torch.profiler``) and the device's idle share, with CUDA events
   around each kernel wrapper giving each kernel's time by batch size and
   width;
6. runs one round at N = 1,152 (Nk = 384 per edge) against its plain arm,
   to show how a round scales with Nk;
7. runs the main path of step 4 under ``REPRO_REDUCE_IMPL=barrett`` (the
   reference's Barrett arm, set for this phase only): the same checks
   against the same plain history, with modexp[barrett,win4] and
   modexp_fixed[barrett] launched and no Montgomery body but the product
   tree's (its body follows the moduli: Montgomery when all are odd);
8. runs ``modexp`` at the shapes the protocol surface adds: the ``vec``
   arm's matvec at n^2 (k = 128 words, B = 36,864, 64-bit exponents;
   Montgomery and Barrett win4, the plain version on the first 1,024
   rows) and the collaborative unmask factors at p^2 with 2,048-bit
   exponents (B = 192), each timed and held against its plain version
   and Python ints, with its instantiation's registers and spills;
9. runs the protocol surface at the main path's key and cut, each with
   the launch counts set to 0 just before it and read just after (every
   body of the Montgomery main path must launch): the ``vec`` arm
   (history equal to the plain arm's, its ciphertexts and final rng
   state equal to the gold arm's of step 4); ``collaborative=True``
   (history equal to the plain arm's, one decryption assist per edge per
   round) and ``collab_encrypt_vec`` on 192 plaintexts against scalar
   ``collaborative_encrypt`` on a sample; each of the seven other
   workload families (spec from ``calibrate_spec``, every edge's block
   192 wide, 2 iterations, the streaming family 3) against its plain
   arm; LASSO under ``ChurnSchedule.quarter(K, 5)`` with recycled
   updates against its plain arm; and a ``health=True`` run;
10. runs the event-driven runtime (``repro_torch.runtime``) at the main
    path's key and cut, each path with the launch counts set to 0 just
    before it and read just after: ``run_on_runtime`` with the gold arm
    on a star (history equal to the plain arm's, RunReport core equal to
    step 4's synchronous run; the K edges' matvecs fused into one
    ``modexp`` launch per CRT half per round at B = K Nk^2 = 110,592, and
    one ``modexp_fixed`` launch per round for the encryptions and one for
    the decryptions); the ``vec`` arm (one n^2 ``modexp`` launch per
    round at B = 110,592, core equal to step 9's ``vec`` run); deadline
    mode with a 10x slow edge behind a slow link, the coalescing queue
    holding lone ops (``coalesce_hold_ticks="auto"``), against the plain
    arm under the same schedule (links whose bandwidth makes ciphertext
    size irrelevant): equal history, equal nonzero stale events, equal
    virtual round times; ``cipher="auto"``: ``dispatch.calibrate`` on the
    card into a fresh cache file under ``build/`` (timed, its table
    printed), then a run that loads that cache without measuring, its
    routes printed, its history equal to the plain arm's; and
    ``python -m repro_torch.launch.edge_sim --backend auto`` as a
    subprocess.  Every kernel shape these paths launch and no earlier
    phase did is held against its plain version (on the host) on sample
    rows of its first launch, and timed by CUDA events around each of its
    launches, beside its bound;
11. runs the serving path (``repro_torch.serve.protocol_engine``) at the
    main path's key and cut, after timing each per-row-modulus body
    (``mulmod_rows`` and ``modexp_rows``, each with both reductions, and
    both ladders) at n^2 over four moduli beside its plain version on the
    same inputs; both ``mulmod_rows`` bodies in turns at S1's and S2's
    shapes (B = 576 ... 4,608 at k = 64 and 128, device time with the
    host's enqueue hidden beside each call's wall time on the host), with
    the sweep of their group and block sizes and, at the same shapes and
    the main path's, the Montgomery body on a one-modulus table in turns
    with ``mulmod``; and the Barrett and Montgomery win4 ``modexp_rows``
    bodies in
    turns at S1's three shapes (the fused matvec, a round's encryptions
    and decryptions), each held against its plain version and Python
    ints on sample rows, with the sweep of the Montgomery bodies' group
    and block sizes (resident integers per SM by shared memory and by
    registers, from ``-Xptxas -v``): S1, a concurrent
    ``ProtocolEngine`` of four gold LASSO tenants (seeds 0-3, 2 rounds),
    each tenant's history, report core (``diff_reports`` clean) and rng
    post-state equal to its solo ``run_on_runtime`` on the card, every
    history equal to the plain chain, fused launches and fewer launches
    than the solo runs' sum, the kernels' summed device time and the wall
    time of the fused run beside the solo runs'; S2, mixed widths and
    arms (2,048- and 1,024-bit gold tenants, a vec tenant, one tenant
    admitted late and one cancelled after a round), no launch mixing
    widths and every tenant equal to its solo run; each with the launch
    counts set to 0 just before it and read just after.  Every rows shape
    they launch is held against its plain version (on the card) on sample
    rows of its first launch, and timed by CUDA events beside its bound.
    S3 runs ``python -m repro_torch.launch.serve_sim`` with 8 tenants and
    a trace, ``serve_sim --admission auto --tune`` into the calibration
    cache, ``python -m repro_torch.obs.report --json`` on the trace and
    ``python -m repro_torch.obs.sentinel --json`` on this run's ledger as
    subprocesses (the sentinel may report perf findings, exit 1; exit 2
    or a correctness finding fails).  The product-tree kernel
    (``prodtree.cu``, both bodies) at S1's fused matvec (2,304 rows of 192
    factors at n^2 over four moduli), the main path's (192 rows, one
    modulus), the runtime's (576 rows) and on a table with an even
    modulus is timed in turns with the tree of ``mulmod_rows`` /
    ``mulmod`` launches it replaced (rebuilt here from the public ops),
    held against its plain version (on the card) and Python ints on sample
    rows and against the old tree on every row, with the sweep of its
    group size, groups a row and block size.  S4 runs S1's fused
    ``enc_rows``, ``add_rows``, ``matvec_rows`` and ``dec_rows`` (four
    2,048-bit tenants, S1's shapes) under
    ``torch.cuda.set_sync_debug_mode("error")`` up to the first read-back
    of a result (``bigint.to_ints``), so any wait for the device before it
    fails the run, then decrypts every result against Python ints;
12. runs the LM serving stack (``repro_torch.models``, ``serve.engine``,
    ``launch.serve``; plain PyTorch, bfloat16 matmuls on a weight copy
    the engine casts once): L1, Yi-9B at its full configuration (48
    layers, d_model 4,096, 8.83 B parameters), ``Engine.generate`` at
    batch 4, prompt 16, 32 new tokens, a 2,048-token prefill at batch 1
    (the flash path), prefill and decode against ``forward`` within
    0.15 and the int8 cache's decode against the bf16 cache's within
    0.25, with its parameter count, peak memory, prefill tokens/s,
    decode ms per step and the step's kernels' time replayed as a CUDA
    graph (its device time without the host between launches); L2, the other nine archs at full width (xLSTM,
    SeamlessM4T and RecurrentGemma at full depth, the other six cut to 2
    layers), each ``Engine.generate`` at batch 4, prompt 16, 16 new
    tokens, prefill and decode against ``forward`` within 0.15 in
    float32 (MoE with capacity E / top_k) and their bf16 gaps printed;
    L3, each reduced config in float32 on the card equal to the CPU
    token for token, logits within 1e-3 (TF32 off); L4, ``python -m
    repro_torch.launch.serve --arch xlstm_125m --batch 4`` as a
    subprocess;
13. trains (``repro_torch.train``, ``data.pipeline``, ``launch.train``;
    plain PyTorch and ``torch.distributed``): T1, Yi-9B at full width
    with 8 of its 48 layers (1.91 B parameters), bf16 matmuls on float32
    master weights, remat, six ``make_train_step`` steps at batch 4 x
    1,024 from ``TokenPipeline`` (finite losses, the last below the
    first), with its step time, tokens/s, peak memory, the step's bound
    and one more step split by CUDA events (loss and backward, AdamW); T2, ``python -m repro_torch.launch.train --arch xlstm_125m``
    (full configuration) for 8 steps with a checkpoint every 4 (the
    loss falls), then, with step 8's checkpoint removed, ``--resume``
    from step 4: the pipeline cursor continues, the first resumed loss
    equals the uninterrupted run's and the others lie within 1e-2; T3,
    each reduced config in float32 on the card against the CPU from the
    same weights: loss and grad norm within 1e-4 relative, each gradient
    leaf within 1e-4 of its max-abs, and after one ``make_train_step``
    step each parameter within 0.5 lr; T4, ``make_dp_compressed_step``
    (bits 8, error feedback) for 8 steps on a one-rank NCCL process
    group (the loss falls) and ``make_spmd_admm`` on it against its run
    on a gloo group on the CPU (within 1e-10), the group torn down after;
14. runs the 2-D sharding and the dry-run (``launch.mesh``,
    ``registry.param_pspecs``, DTensor; ``launch.dryrun``): D1, T1's
    model, weights and batches with parameters and moments as DTensors
    at ``param_pspecs``'s placements on a 1 x 1 ``("data", "model")``
    mesh over a one-rank NCCL group, the activation sharding installed,
    three steps: each loss within 1e-3 relative of T1's unsharded
    step's and each parameter within 0.5 lr of T1's after three steps,
    with the step time beside T1's and the peak memory; D2, the
    dry-run's accounting of T1's step and shapes on a fake one-rank
    mesh: its predicted peak within 15 % of T1's measured peak, and its
    counted bf16 matmul flops within 3 % of ``train_step_bound``'s;
    D3, ``python -m repro_torch.launch.dryrun --arch yi_9b`` (four
    shapes on the fake 16 x 16 mesh, ``long_500k`` skipped) and
    ``--arch qwen2_moe_a27b --shape train_4k`` as two subprocesses run
    side by side, on the host beside step 15's card work: every cell ok
    or skipped, each cell's peak per card beside the H100's 80 GB, its
    bottleneck and its three terms;
15. runs the port's entry points and the batch split: E, the six
    examples (``repro_torch.examples``: quickstart, edge_network_sim,
    workload_zoo, power_grid_reconstruction, serve_batched,
    train_lm_secure in its smoke mode) through their ``main`` on the card
    in this process, each with the launch counts set to 0 just before it
    and read just after: each passes its own asserts and prints ``OK``,
    the gold examples (quickstart, every workload_zoo family) launch the
    three main-path bodies and their histories equal their plain arms'
    bit for bit, with each example's wall time; M, ``kernel_mesh()`` is
    None and ``device_kind()`` has no ``xN`` suffix on the one card, then
    one main-path round's batched ops (enc of 192 plaintexts, a
    192 x 192 matvec, dec of its rows; 2048-bit key) run whole and split
    over ``[cuda:0, cuda:0]``: equal ciphertexts, plaintexts and rng
    state, and every launch made inside a CRT body made again for each
    chunk at half the batch;
16. prints the kernel table as one JSON line (each body's launches on the
    main path — for the per-row bodies on S1 — on the Barrett arm, on
    each path of steps 9, 10 and 11, in the examples and whole/split in
    M; the LM stack, serving, training and sharding have no kernel of
    their own), then as its last line ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and prints no
result.  Exact integer work: the tolerance of every comparison is zero;
the LM checks' tolerances are stated in steps 12, 13 and 14.
"""
import contextlib
import dataclasses
import functools
import io
import json
import os
import random
import re
import subprocess
import sys
import time
from collections import defaultdict
from dataclasses import replace

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))

# Main-path scale (Fig. 6 of the paper, N and M cut to fit the time limit)
KEY_BITS, DELTA, K, RHO, LAM = 2048, 1e15, 3, 1.0, 1.0
N, M, ITERS, SEED = 576, 64, 3, 0
NK = N // K
N_SCALED = 1152                 # one more round at Nk = 384
DEVICE = "cuda"                 # where every protocol phase runs

# H100 SXM peaks (NVIDIA data sheet): HBM 3.35 TB/s; fp32 67 TFLOP/s
# counts 2 flops per FMA on 128 FMA lanes per SM, and the 32-bit integer
# multiply-add pipe has 64 lanes per SM on compute capability 9.0 (CUDA C++
# Programming Guide, arithmetic instruction throughput), so 32-bit IMAD
# results peak at 67e12 / 4 per second.  A 32x32->64-bit word product is
# two IMAD results (low and high word).
HBM_BYTES_PER_S = 3.35e12
IMAD_PER_S = 67e12 / 4

CSRC = "src/repro_torch/kernels/csrc"
# body -> (source, the TPU kernel body it replaces)
BODY_SOURCES = {
    "mulmod": ("mulmod.cu", "src/repro/kernels/limb_mulmod.py:32"),
    "modexp[montgomery,win4]": ("modexp.cu", "src/repro/kernels/modexp.py:55"),
    "modexp[montgomery,binary]": ("modexp.cu",
                                  "src/repro/kernels/modexp.py:49"),
    "modexp[barrett,win4]": ("modexp.cu", "src/repro/kernels/modexp.py:44"),
    "modexp[barrett,binary]": ("modexp.cu", "src/repro/kernels/modexp.py:40"),
    "modexp_fixed[montgomery]": ("modexp_fixed.cu",
                                 "src/repro/kernels/modexp.py:62"),
    "modexp_fixed[barrett]": ("modexp_fixed.cu",
                              "src/repro/kernels/modexp.py:69"),
    # the serving path's per-row-modulus bodies; the reference runs them
    # as jitted jnp, not Pallas
    "mulmod_rows[montgomery]": ("mulmod.cu", "src/repro/kernels/ops.py:409"),
    "mulmod_rows[barrett]": ("mulmod.cu", "src/repro/kernels/ops.py:409"),
    "modexp_rows[barrett,win4]": ("modexp.cu",
                                  "src/repro/kernels/ops.py:417"),
    "modexp_rows[barrett,binary]": ("modexp.cu",
                                    "src/repro/kernels/ops.py:417"),
    "modexp_rows[montgomery,win4]": ("modexp.cu",
                                     "src/repro/kernels/ops.py:417"),
    "modexp_rows[montgomery,binary]": ("modexp.cu",
                                       "src/repro/kernels/ops.py:417"),
    # the product tree of every matvec (the reference's jitted
    # _prod_rows8, and mul_tree's levels of mulmod_pallas)
    "prod_rows[montgomery]": ("prodtree.cu", "src/repro/kernels/ops.py:439"),
    "prod_rows[barrett]": ("prodtree.cu", "src/repro/kernels/ops.py:439"),
}
MAIN_PATH_BODIES = ("mulmod", "modexp[montgomery,win4]",
                    "modexp_fixed[montgomery]", "prod_rows[montgomery]")
# the main path under REPRO_REDUCE_IMPL=barrett
BARRETT_ARM_BODIES = ("mulmod", "modexp[barrett,win4]",
                      "modexp_fixed[barrett]", "prod_rows[montgomery]")
# every instantiation must keep its rows in registers
MAX_STACK = 256


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
# build report
# ---------------------------------------------------------------------------

def demangle(sym):
    """``_Z18modexp_mont_kernelILi8ELi8ELb1EEv...`` ->
    ``modexp_mont_kernel<8,8,true>`` (kernel templates over ints and
    bools only)."""
    m = re.match(r"_Z(\d+)", sym)
    if not m:
        return sym
    n, start = int(m.group(1)), m.end()
    name, rest = sym[start:start + n], sym[start + n:]
    if not rest.startswith("I"):
        return name
    args = re.findall(r"L([ib])(\d+)E", rest[:rest.index("EEv") + 1])
    vals = [v if t == "i" else ("true" if v == "1" else "false")
            for t, v in args]
    return f"{name}<{','.join(vals)}>"


def ptxas_report(logs):
    """Per instantiation: registers, stack frame and spill bytes."""
    rows = {}
    for text in logs.values():
        cur = None
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                cur = demangle(m.group(1))
                rows[cur] = {}
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
            if m and cur:
                rows[cur].update(stack=int(m.group(1)),
                                 spill_stores=int(m.group(2)),
                                 spill_loads=int(m.group(3)))
            m = re.search(r"Used (\d+) registers", line)
            if m and cur:
                rows[cur]["registers"] = int(m.group(1))
    return rows


def build_kernels(build):
    t0 = time.perf_counter()
    logs = build.build_all(ptxas_verbose=True, rebuild=True)
    log(f"build: {time.perf_counter() - t0:.2f} s ({len(logs)} sources "
        f"compiled)")
    rows = ptxas_report(logs)
    for name, r in sorted(rows.items()):
        log(f"  ptxas {name}: {r.get('registers')} registers, "
            f"{r.get('stack')} B stack, {r.get('spill_stores')} B spill "
            f"stores, {r.get('spill_loads')} B spill loads")
        assert r.get("spill_stores") == 0 and r.get("spill_loads") == 0 \
            and r.get("stack", MAX_STACK) < MAX_STACK, \
            f"{name} keeps rows in local memory: {r}"
    templates = {name.split("<")[0] for name in rows}
    assert templates == {"mulmod_kernel", "modexp_kernel",
                         "modexp_fixed_kernel", "mulmod_rows_kernel",
                         "modexp_rows_kernel", "prod_rows_kernel"}, \
        f"kernel templates in the ptxas report: {sorted(templates)}"
    # every body of modexp and of the per-row modexp (window x product)
    # and of modexp_fixed
    both = (",true,true>", ",false,true>", ",true,false>", ",false,false>")
    for template, bodies in (("modexp_kernel", both),
                             ("modexp_fixed_kernel", (",true>", ",false>")),
                             ("modexp_rows_kernel", both),
                             ("mulmod_rows_kernel", (",true>", ",false>")),
                             ("prod_rows_kernel", (",true>", ",false>"))):
        for tail in bodies:
            assert any(n.startswith(template + "<") and n.endswith(tail)
                       for n in rows), f"no {template}<...{tail}"
    return rows


def check_spills(inst_name, regs):
    """An instantiation keeps its rows in registers (its ptxas line)."""
    assert regs.get("spill_stores") == 0 and \
        regs.get("stack", MAX_STACK) < MAX_STACK, (inst_name, regs)


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


def word_products(kernel, k, exp_bits=0, mont=True, win4=True, factors=0):
    """Least 32x32-bit word products one element of a launch needs, by
    the kernel's ladder with the squaring saving taken; for ``prod_rows``
    one row's product of ``factors``: N - 1 modular products, each a
    product and the cheaper reduction, whatever the body."""
    if kernel == "mulmod":
        return _product(k, False) + _barrett(k)
    if kernel == "prod_rows":
        return (factors - 1) * (_product(k, False)
                                + min(_redc(k), _barrett(k)))
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


def kernel_symbol(body):
    """The CUDA kernel template a body's launches run."""
    if body == "mulmod":
        return "mulmod_kernel"
    if body.startswith("modexp_fixed"):
        return "modexp_fixed_kernel"
    if body.startswith("prod_rows"):
        return "prod_rows_kernel"
    return "modexp_kernel"


def kernel_ms(fn, reps, symbol):
    """Device milliseconds per call of the kernel ``symbol`` that ``fn``
    launches once per call (``torch.profiler``, after a warm-up call), the
    CUDA-event milliseconds per call of ``fn`` (which include the host's
    gaps between launches: at small batches the wrapper's own time), and
    the warm-up call's result.  Where the profiler shows no device time
    the event time stands for both."""
    from torch.profiler import ProfilerActivity, profile
    event_ms, result = time_ms(fn, reps)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and symbol in e.name]
    if not us:
        return event_ms, event_ms, result
    # the profiler may drop an event of a long run: average those it kept
    assert len(us) <= reps, (symbol, len(us), reps)
    return sum(us) / 1e3 / len(us), event_ms, result


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
    """Every body against its plain version and Python ints at small
    batches; :func:`time_kernels` adds the main path's batches."""
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


def time_kernels(key, packs, bi, geometry, mg, lm, mx, dev):
    """Each body at the main path's shapes: timed beside its plain
    version on the same inputs, and both outputs held against each other
    (zero tolerance) and against Python ints on a sample.  The group-size
    candidates of every body run on the same inputs and are
    held against the same plain output."""
    rng = random.Random(SEED + 2)
    out, sweep, shapes = {}, [], []

    def rows(B, L):
        ints = [rng.getrandbits(16 * L) for _ in range(B)]
        return ints, torch.as_tensor(bi.from_ints(ints, L), device=dev)

    def measure(name, kernel, plain, reps, want, shape, products, B,
                nbytes, k):
        ms, event_ms, got = kernel_ms(kernel, reps, kernel_symbol(name))
        plain_ms, ref = time_ms(plain, 1)
        bnd, by = bound_ms(products, B, nbytes)
        row = dict(shape=shape, B=B, k=k, ms=ms, event_ms=event_ms,
                   plain_ms=plain_ms,
                   max_abs_err=compare(bi, name, got, ref, want),
                   bound_ms=bnd, bound_by=by)
        out.setdefault(name, row)              # the body's first shape
        shapes.append(dict(body=name, **row))
        log(f"  {name} {shape}: {ms:.4f} ms on the device, {event_ms:.4f} "
            f"ms per call (plain {plain_ms:.1f} ms, bound {bnd:.4f} ms), "
            f"equal")
        return ref

    def candidates(name, launch, ref, want, reps, B, k):
        """Every instantiated group size of ``name``'s kernel at B x k."""
        chosen = geometry.launch_geometry(name, B, k).tpi
        for tpi in sorted({t for t, _ in geometry.SHAPES[name]}):
            g = geometry.launch_geometry(name, B, k, tpi)
            ms, event_ms, got = kernel_ms(lambda: launch(tpi), reps,
                                          kernel_symbol(name))
            compare(bi, f"{name} tpi={tpi}", got, ref, want)
            sweep.append(dict(body=name, B=B, k=k, tpi=tpi, words=g.words,
                              per_block=g.per_block, blocks=g.blocks,
                              smem=g.smem, ms=ms, event_ms=event_ms,
                              chosen=tpi == chosen))
            log(f"  {name} B={B} k={k} tpi={tpi} ({g.words} words per "
                f"thread, {g.blocks} blocks of {g.threads}): {ms:.4f} ms, "
                f"equal")

    def time_pair(ref_p, bpt, win_p, dm_p, want_p):
        """Both CRT halves of the main path's fixed exponentiation in one
        launch (B = 2 Nk), against two launches of Nk on the same rows;
        the q^2 half is held against the plain Barrett version."""
        pq = packs["q2"]
        dm_q = pq.on(dev)
        bq, bqt = rows(NK, pq.L16)
        e_q = key.lam % key.phi_q2
        win_q = mg.exp_windows(e_q)
        pair_ms, (xp, xq) = time_ms(lambda: mx.modexp_fixed_pair_cuda(
            (bpt, bqt), (win_p, win_q), (dm_p, dm_q)), 10)
        two_ms, _ = time_ms(lambda: (
            mx.modexp_fixed_cuda(bpt, win_p, dm_p, "montgomery"),
            mx.modexp_fixed_cuda(bqt, win_q, dm_q, "montgomery")), 10)
        compare(bi, "modexp_fixed pair p^2", xp, ref_p, want_p)
        compare(bi, "modexp_fixed pair q^2", xq,
                mx.modexp_fixed_plain(bqt, win_q, dm_q, "barrett"),
                [pow(x, e_q, pq.m_int) for x in bq[:4]])
        log(f"  modexp_fixed[montgomery] both halves in one launch "
            f"(B={2 * NK}): {pair_ms:.3f} ms; two launches of {NK}: "
            f"{two_ms:.3f} ms; equal")
        return dict(pair_ms=pair_ms, two_launches_ms=two_ms, B=2 * NK)

    # mulmod at each main-path shape: an edge's matvec reduced into p^2
    # (Nk^2 rows) first, the kernel table's shape; one encryption's or
    # sum's Nk rows on n^2; the CRT and half-space multiplies' Nk rows on
    # p^2
    for width, B in (("p2", NK * NK), ("n2", NK), ("p2", NK)):
        pack = packs[width]
        dm = pack.on(dev)
        (a, at), (b, bt) = rows(B, pack.L16), rows(B, pack.L16)
        want = [(x * y) % pack.m_int for x, y in zip(a[:4], b[:4])]
        ref = measure("mulmod", lambda: lm.mulmod_cuda(at, bt, dm),
                      lambda: lm.mulmod_plain(at, bt, dm), 20, want,
                      f"B={B} {width[0]}^2 {pack.L32} words",
                      word_products("mulmod", pack.L32), B,
                      3 * B * pack.L16 * 4, pack.L32)
        candidates("mulmod", lambda tpi: lm.mulmod_cuda(at, bt, dm, tpi=tpi),
                   ref, want, 20, B, pack.L32)
    # modexp: one edge's matvec in one half space, Nk^2 elements, 4-limb
    # (64-bit) exponents as Gamma_2 codes of Delta = 1e15 need
    pack = packs["p2"]
    dm = pack.on(dev)
    B = NK * NK
    (base, bt), (exps, et) = rows(B, pack.L16), rows(B, 4)
    want = [pow(x, e, pack.m_int) for x, e in zip(base[:4], exps[:4])]
    for impl in ("montgomery", "barrett"):
        for method in ("win4", "binary"):
            mont = impl == "montgomery"
            name = f"modexp[{impl},{method}]"
            ref = measure(
                name, lambda: mx.modexp_cuda(bt, et, dm, method, impl),
                lambda: mx.modexp_plain(bt, et, dm, method, impl),
                10, want,
                f"B={B} p^2 {pack.L32} words, 64-bit exps",
                word_products("modexp", pack.L32, exp_bits=64, mont=mont,
                              win4=method == "win4"),
                B, B * (2 * pack.L16 + 4) * 4, pack.L32)
            candidates(name, lambda tpi: mx.modexp_cuda(
                bt, et, dm, method, impl, tpi=tpi), ref, want, 10, B,
                pack.L32)
    # modexp_fixed: one encryption's r^n / decryption's c^lam half, Nk rows
    B = NK
    base, bt = rows(B, pack.L16)
    e = key.lam % key.phi_p2
    win = mg.exp_windows(e)
    want = [pow(x, e, pack.m_int) for x in base[:4]]
    for impl in ("montgomery", "barrett"):
        mont = impl == "montgomery"
        name = f"modexp_fixed[{impl}]"
        ref = measure(name, lambda: mx.modexp_fixed_cuda(bt, win, dm, impl),
                      lambda: mx.modexp_fixed_plain(bt, win, dm, impl),
                      10, want,
                      f"B={B} p^2 {pack.L32} words, {len(win)} windows",
                      word_products("modexp_fixed", pack.L32,
                                    exp_bits=4 * len(win), mont=mont),
                      B, 2 * B * pack.L16 * 4 + 4 * len(win), pack.L32)
        candidates(name, lambda tpi: mx.modexp_fixed_cuda(
            bt, win, dm, impl, tpi=tpi), ref, want, 10, B, pack.L32)
        if mont:
            pair = time_pair(ref, bt, win, dm, want)
    return out, sweep, pair, shapes


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


def lasso_config(protocol, QuantSpec, cipher, iters):
    spec = QuantSpec(delta=DELTA, zmin=-16.0, zmax=16.0)
    return protocol.ProtocolConfig(K=K, rho=RHO, lam=LAM, iters=iters,
                                   spec=spec, cipher=cipher,
                                   key_bits=KEY_BITS, seed=SEED,
                                   device=DEVICE)


@contextlib.contextmanager
def environ(name, value):
    """``os.environ[name] = value`` inside the block, restored after."""
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = old


def run_plain(protocol, QuantSpec, make_lasso):
    """The plain arm of the main path: the history every gold run must
    equal bit for bit."""
    inst = make_lasso(M, N, sparsity=0.1, noise=0.01, seed=SEED)
    res = protocol.run_protocol(
        inst.A, inst.y, lasso_config(protocol, QuantSpec, "plain", ITERS))
    assert res.history.shape == (ITERS, N)
    return res.history


def drive(protocol, build, inst, cfg, **kw):
    """One ``run_protocol`` call with a recording box, the launch counts
    set to 0 just before it and read just after; returns the result, the
    box, the wall seconds and the launches by body and by shape."""
    rec = {}
    real_make_box = protocol.make_box

    def recording_make_box(*a, **kw_):
        box, key = real_make_box(*a, **kw_)
        rec["box"] = RecordingBox(box)
        return rec["box"], key

    protocol.make_box = recording_make_box
    try:
        build.reset_launches()
        t0 = time.perf_counter()
        res = protocol.run_protocol(inst.A, inst.y, cfg, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(build.LAUNCHES)
        shape_launches = dict(build.SHAPE_LAUNCHES)
    finally:
        protocol.make_box = real_make_box
    return res, rec["box"], wall, launches, shape_launches


def check_launches(path, launches, bodies, absent=()):
    for name in bodies:
        assert launches[name] > 0, \
            f"kernel body {name} was not launched on the {path}"
    for name in absent:
        assert launches[name] == 0, \
            f"kernel body {name} was launched {launches[name]} times on " \
            f"the {path}"


def check_one_tree(path, launches, modexp_body, tree_body):
    """One product-tree launch per matvec, whose two CRT halves each run
    one ``modexp`` launch."""
    assert launches[modexp_body] == 2 * launches[tree_body] > 0, \
        f"{path}: {launches[tree_body]} product trees for " \
        f"{launches[modexp_body]} matvec halves"
    log(f"  {path}: one product-tree launch per matvec "
        f"({launches[tree_body]}); mulmod launches {launches['mulmod']}")


def check_first_round(box, gold, bi):
    """Replay the blinding rng: the share phase's K encryptions, then the
    first round's (z, v) pair per edge; each of the first round's calls'
    first rows must equal scalar ``encrypt_crt``.  Returns the count."""
    rng = random.Random(SEED)
    key = gold.keygen(KEY_BITS, rng)
    assert key == box.key
    checked = 0
    for idx, (ms, c) in enumerate(box.calls[:3 * K]):
        rs = [gold.rand_r(key, rng) for _ in ms]
        if idx >= K:                           # the first round's calls
            limbs = c.limbs if hasattr(c, "limbs") else c
            got = bi.to_ints(limbs[:4])
            want = [gold.encrypt_crt(key, int(m), r)
                    for m, r in zip(ms[:4], rs[:4])]
            assert got == want, f"ciphertext mismatch in call {idx}"
            checked += len(got)
    return checked


def run_main_path(protocol, gold, bi, build, QuantSpec, make_lasso,
                  plain_history, bodies, absent=()):
    """The gold main path with the launch counts set to 0 just before it
    and read just after: every body of ``bodies`` launched, none of
    ``absent``; its history equal to the plain arm's, and a sample of the
    first round's ciphertexts equal to scalar ``encrypt_crt``."""
    inst = make_lasso(M, N, sparsity=0.1, noise=0.01, seed=SEED)
    gold_res, box, wall, launches, shape_launches = drive(
        protocol, build, inst,
        lasso_config(protocol, QuantSpec, "gold", ITERS))
    assert gold_res.history.shape == (ITERS, N)
    assert np.all(np.isfinite(gold_res.history))
    assert gold_res.history.tobytes() == plain_history.tobytes(), \
        "gold history differs from the plain arm"
    check_launches("main path", launches, bodies, absent)
    checked = check_first_round(box, gold, bi)
    return gold_res, wall, launches, shape_launches, checked, box


def report_path(wall, secs, checked, launches, shape_launches):
    log(f"  wall {wall:.2f} s; init {secs['init']:.3f} s, share "
        f"{secs['share']:.3f} s, iterate {secs['iterate']:.3f} s; rounds "
        + ", ".join(f"{s:.4f}" for s in secs["rounds"]) + " s")
    log(f"  history equals the plain arm bit for bit; {checked} sampled "
        f"ciphertexts equal scalar encrypt_crt; launches {launches}")
    log("  launches by shape: " + json.dumps(
        [{"body": body, "B": B, "k": k, "launches": n}
         for (body, B, k), n in sorted(shape_launches.items())]))


def _kernel_group(name):
    if "prod_rows_kernel" in name:
        return "prod_rows"
    if "mulmod_kernel" in name:
        return "mulmod"
    if "modexp_fixed" in name:
        return "modexp_fixed"
    if "modexp" in name:
        return "modexp"
    if name.startswith(("Memcpy", "Memset")):
        return "memcpy/memset"
    return "plain torch kernels"


def time_split(protocol, lm, mx, QuantSpec, make_lasso, first_row,
               round_s):
    """One main-path round (round 0 after the share phase, in a run of its
    own) under ``torch.profiler``: device time by kernel, and the device's
    idle share of that round's wall time and of ``round_s`` (the median
    round of the unprofiled run; the profiler adds host time).  CUDA
    events around each kernel wrapper time every launch of the round with
    its batch size."""
    from torch.profiler import ProfilerActivity, profile, schedule
    from repro_torch.kernels import prodtree
    inst = make_lasso(M, N, sparsity=0.1, noise=0.01, seed=SEED)
    records, recording, traces = [], [False], []

    def timed(mod, attr, label, dm_at=2):
        real = getattr(mod, attr)

        def wrapper(*args, **kwargs):
            if not recording[0]:
                return real(*args, **kwargs)
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            result = real(*args, **kwargs)
            stop.record()
            rows = args[0] if isinstance(args[0], torch.Tensor) \
                else args[0][0]                # a pair: B and k per half
            dm = args[dm_at] if not isinstance(args[dm_at], tuple) \
                else args[dm_at][0]
            records.append((label, int(rows.shape[0]), dm.L32, start,
                            stop))
            return result
        setattr(mod, attr, wrapper)
        return mod, attr, real

    patched = [timed(lm, "mulmod_cuda", "mulmod"),
               timed(mx, "modexp_cuda", "modexp"),
               timed(mx, "modexp_fixed_cuda", "modexp_fixed"),
               timed(mx, "modexp_fixed_pair_cuda", "modexp_fixed pair"),
               timed(prodtree, "prod_rows_cuda", "prod_rows", dm_at=1)]
    real_lap = protocol._PhaseClock.lap

    def on_trace(prof):
        traces.append([(e.name, e.time_range.elapsed_us())
                       for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       and not e.name.startswith("ProfilerStep")])

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=1, warmup=1, active=1),
                 on_trace_ready=on_trace) as prof:
        def lap(clock, phase):                 # init: wait, share: warmup,
            real_lap(clock, phase)             # round 0: recorded
            prof.step()
            recording[0] = phase == protocol.PHASE_SHARE

        protocol._PhaseClock.lap = lap
        try:
            res = protocol.run_protocol(
                inst.A, inst.y, lasso_config(protocol, QuantSpec, "gold", 1))
        finally:
            protocol._PhaseClock.lap = real_lap
            for mod, attr, real in patched:
                setattr(mod, attr, real)
    assert res.history[0].tobytes() == first_row.tobytes(), \
        "profiled round differs from the main path's first round"
    torch.cuda.synchronize()
    round_ms = 1e3 * res.stats["seconds"]["rounds"][0]
    by_shape = defaultdict(lambda: [0, 0.0])
    for label, B, k, start, stop in records:
        by_shape[(label, B, k)][0] += 1
        by_shape[(label, B, k)][1] += start.elapsed_time(stop)
    device = defaultdict(lambda: [0, 0.0])
    plain_names = defaultdict(float)
    for name, us in (traces[0] if traces else []):
        group = _kernel_group(name)
        device[group][0] += 1
        device[group][1] += us / 1e3
        if group == "plain torch kernels":
            plain_names[name[:60]] += us / 1e3
    busy_ms = sum(ms for _, ms in device.values())
    profiler_saw_device = busy_ms > 0
    if not profiler_saw_device:                # events: our kernels only
        for (label, _, _), (n, ms) in by_shape.items():
            device[label][0] += n
            device[label][1] += ms
        busy_ms = sum(ms for _, ms in device.values())
    split = {
        "round_ms": round_ms, "device_busy_ms": busy_ms,
        "idle_share": 1.0 - busy_ms / round_ms,
        "unprofiled_round_ms": 1e3 * round_s,
        "idle_share_of_unprofiled_round": 1.0 - busy_ms / (1e3 * round_s),
        "profiler_device_time": profiler_saw_device,
        "device_ms_by_kernel": {g: {"launches": n, "ms": ms}
                                for g, (n, ms) in sorted(device.items())},
        "top_plain_torch_kernels_ms": dict(sorted(
            plain_names.items(), key=lambda kv: -kv[1])[:6]),
        "event_ms_by_shape": [
            {"kernel": label, "B": B, "k": k, "launches": n, "ms": ms}
            for (label, B, k), (n, ms) in sorted(by_shape.items())],
    }
    return split


def run_scaled(protocol, QuantSpec, make_lasso):
    """One round at N = N_SCALED against its plain arm."""
    inst = make_lasso(M, N_SCALED, sparsity=0.1, noise=0.01, seed=SEED)
    runs = {}
    for cipher in ("gold", "plain"):
        cfg = lasso_config(protocol, QuantSpec, cipher, 1)
        runs[cipher] = protocol.run_protocol(inst.A, inst.y, cfg)
    gold_res = runs["gold"]
    assert gold_res.history.shape == (1, N_SCALED)
    assert gold_res.history.tobytes() == runs["plain"].history.tobytes(), \
        f"gold history differs from the plain arm at N = {N_SCALED}"
    return gold_res.stats["seconds"]


# ---------------------------------------------------------------------------
# the protocol surface: new kernel shapes, the vec arm, Algorithm 3, the
# other families, churn and the health watchers
# ---------------------------------------------------------------------------

#: rows of the n^2 modexp batch held against the plain version (the plain
#: version of the whole batch would take about half a minute)
NSQ_ROWS = 1024
#: exponent bits of the collaborative mode's unmask factors, -t mod phi(p^2)
LONG_EXP_BITS = 2048
FAMILIES = ("ridge", "logistic", "elastic_net", "power_grid",
            "consensus_lasso", "consensus_logistic", "streaming_lasso")
ROW_SPLIT = ("consensus_lasso", "consensus_logistic")
FAMILY_ITERS = 2
CHURN_ITERS = 5
#: paths added by the protocol-surface slice, in the order they run; each
#: launches the Montgomery main path's three bodies
SURFACE_PATHS = ("vec_arm", "collab", "families", "churn", "health")


def once_ms(fn):
    """Milliseconds of one call of ``fn`` (CUDA events, no warm-up; for
    the plain versions, whose launches are many and small) and its
    result."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    result = fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop), result


def time_new_shapes(key, packs, bi, geometry, mx, ptxas, dev):
    """``modexp`` at the shapes this slice's paths launch and no earlier
    path did: the vec arm's matvec at n^2 (k = 128 words, B = Nk^2,
    64-bit exponents; Montgomery and Barrett win4, the plain version on
    the first NSQ_ROWS rows), and the collaborative mode's unmask factors
    at p^2 with 2,048-bit exponents (B = Nk).  Each held against its
    plain version (zero tolerance) and Python ints on a sample."""
    rng = random.Random(SEED + 3)
    rows_out = []

    def rows(B, L, below=None):
        ints = [rng.randrange(below) if below else rng.getrandbits(16 * L)
                for _ in range(B)]
        return ints, torch.as_tensor(bi.from_ints(ints, L), device=dev)

    cases = []
    pack = packs["n2"]
    B = NK * NK
    cases += [(f"modexp[{impl},win4]", impl, pack, B, 64, NSQ_ROWS)
              for impl in ("montgomery", "barrett")]
    cases.append(("modexp[montgomery,win4]", "montgomery", packs["p2"], NK,
                  LONG_EXP_BITS, NK))
    for name, impl, pack, B, exp_bits, plain_rows in cases:
        plain_rows = min(plain_rows, B)
        dm = pack.on(dev)
        base, bt = rows(B, pack.L16)
        le = exp_bits // 16
        below = key.phi_p2 if exp_bits == LONG_EXP_BITS else None
        exps, et = rows(B, le, below)
        want = [pow(x, e, pack.m_int) for x, e in zip(base[:4], exps[:4])]
        ms, event_ms, got = kernel_ms(
            lambda: mx.modexp_cuda(bt, et, dm, "win4", impl), 5,
            "modexp_kernel")
        plain_ms, ref = once_ms(lambda: mx.modexp_plain(
            bt[:plain_rows], et[:plain_rows], dm, "win4", impl))
        err = compare(bi, name, got[:plain_rows], ref, want)
        mont = impl == "montgomery"
        bnd, by = bound_ms(
            word_products("modexp", pack.L32, exp_bits=exp_bits, mont=mont),
            B, B * (2 * pack.L16 + le) * 4)
        g = geometry.launch_geometry(name, B, pack.L32)
        inst_name = (f"modexp_kernel<{g.tpi},{g.words},true,"
                     f"{'true' if mont else 'false'}>")
        regs = ptxas.get(inst_name, {})
        check_spills(inst_name, regs)
        row = dict(body=name, B=B, k=pack.L32, exp_bits=exp_bits, ms=ms,
                   event_ms=event_ms, plain_ms=plain_ms,
                   plain_rows=plain_rows, max_abs_err=err, bound_ms=bnd,
                   bound_by=by, instantiation=inst_name, **regs)
        rows_out.append(row)
        log(f"  {name} B={B} k={pack.L32} {exp_bits}-bit exps "
            f"({inst_name}: {regs.get('registers')} registers, "
            f"{regs.get('stack')} B stack, {regs.get('spill_stores')} B "
            f"spills): {ms:.4f} ms on the device, {event_ms:.4f} ms per "
            f"call (plain {plain_ms:.1f} ms on {plain_rows} rows, bound "
            f"{bnd:.4f} ms), equal")
    return rows_out


def report_surface(path, res, wall, launches, shape_launches):
    secs = res.stats["seconds"]
    log(f"  {path}: wall {wall:.2f} s; init {secs['init']:.3f} s, share "
        f"{secs['share']:.3f} s, rounds "
        + ", ".join(f"{t:.4f}" for t in secs["rounds"]) + " s")
    log(f"  {path} launches {launches}; by shape " + json.dumps(
        [{"body": body, "B": B, "k": k, "launches": n}
         for (body, B, k), n in sorted(shape_launches.items())]))


def run_vec_arm(protocol, gold, bi, build, QuantSpec, make_lasso,
                plain_history, gold_box):
    """The vec arm at the main path's cut: its history equal to the plain
    arm's, its ordered ciphertext stream and final rng state equal to the
    gold arm's (same seed), the first round's ciphertexts sampled against
    scalar ``encrypt_crt``."""
    inst = make_lasso(M, N, sparsity=0.1, noise=0.01, seed=SEED)
    res, box, wall, launches, shapes = drive(
        protocol, build, inst, lasso_config(protocol, QuantSpec, "vec",
                                            ITERS))
    assert res.history.tobytes() == plain_history.tobytes(), \
        "vec history differs from the plain arm"
    check_launches("vec arm", launches, MAIN_PATH_BODIES)
    assert len(box.calls) == len(gold_box.calls) == K * (1 + 2 * ITERS)
    for idx, ((mv, cv), (mg_, cg)) in enumerate(zip(box.calls,
                                                   gold_box.calls)):
        assert np.array_equal(mv, mg_) and torch.equal(cv, cg.limbs), \
            f"vec ciphertexts differ from the gold arm's in call {idx}"
    assert box.rng.getstate() == gold_box.rng.getstate(), \
        "vec and gold arms left the blinding rng in different states"
    assert box.plain_bits > 62                 # Delta = 1e15: 109 bits
    checked = check_first_round(box, gold, bi)
    report_surface("vec arm", res, wall, launches, shapes)
    log(f"  vec arm: history equals the plain arm bit for bit; "
        f"{len(box.calls)} encryptions equal the gold arm's limb for limb, "
        f"same rng state; {checked} sampled ciphertexts equal scalar "
        f"encrypt_crt")
    return res, launches, shapes


def run_collaborative(protocol, gold, pb, build, QuantSpec, make_lasso,
                      plain_history, main_shapes):
    """Algorithm 3 on the main path's instance: history equal to the
    plain arm's, one decryption assist (``reduce_p2``) per edge per round
    counted with its launches; then ``collab_encrypt_vec`` on Nk
    plaintexts equal to scalar ``collaborative_encrypt`` on a sample of
    4, the scalar run replaying the draws of a second rng of the same
    seed."""
    inst = make_lasso(M, N, sparsity=0.1, noise=0.01, seed=SEED)
    assists = []
    real = protocol.EdgeNode.reduce_p2

    def counted(self, x_hat):
        out = real(self, x_hat)
        assists.append(len(out))
        return out

    protocol.EdgeNode.reduce_p2 = counted
    try:
        cfg = lasso_config(protocol, QuantSpec, "gold", ITERS)
        res, box, wall, launches, shapes = drive(
            protocol, build, inst, replace(cfg, collaborative=True))
    finally:
        protocol.EdgeNode.reduce_p2 = real
    assert res.history.tobytes() == plain_history.tobytes(), \
        "collaborative history differs from the plain arm"
    check_launches("collaborative path", launches, MAIN_PATH_BODIES)
    assert assists == [NK] * (K * ITERS), assists
    extra = {f"{b} B={B} k={k}": n - main_shapes.get((b, B, k), 0)
             for (b, B, k), n in sorted(shapes.items())
             if n != main_shapes.get((b, B, k), 0)}
    report_surface("collaborative", res, wall, launches, shapes)
    log(f"  collaborative: history equals the plain arm; {len(assists)} "
        f"decryption assists of {NK} rows; launches beyond the main "
        f"path's: {json.dumps(extra)}")

    # collab_encrypt_vec: batched master and edge against the scalar math
    key = box.key
    edge = protocol.EdgeNode(0, cfg.spec)
    edge.collab_setup(key.p2, key.phi_p2, key.g, batch=True, device=DEVICE)
    pick = random.Random(SEED + 4)
    ms = np.array([pick.randrange(10 ** 15) for _ in range(NK)],
                  dtype=object)
    rng1 = random.Random(SEED + 5)
    build.reset_launches()
    t0 = time.perf_counter()
    out = protocol.collab_encrypt_vec(key, edge, ms, rng1, device=DEVICE)
    torch.cuda.synchronize()
    enc_s = time.perf_counter() - t0
    enc_launches = dict(build.LAUNCHES)
    enc_shapes = dict(build.SHAPE_LAUNCHES)
    rng2 = random.Random(SEED + 5)            # replay the same draws
    masks = [rng2.getrandbits(64) for _ in ms]
    rs = pb.rand_r_vec(key, len(ms), rng2)
    assert rng1.getstate() == rng2.getstate()
    sample = (0, 1, NK // 2, NK - 1)
    scalar_edge = protocol.EdgeNode(0, cfg.spec)
    scalar_edge.collab_setup(key.p2, key.phi_p2, key.g, batch=False)
    want = protocol.collaborative_encrypt(
        key, scalar_edge, ms[list(sample)],
        _Replay([masks[i] for i in sample], [rs[i] for i in sample]))
    assert [out[i] for i in sample] == want, \
        "collab_encrypt_vec differs from scalar collaborative_encrypt"
    assert [gold.decrypt_crt(key, out[i]) for i in sample] == \
        [int(ms[i]) for i in sample]
    # the r^n blindings go through modexp_crt_vec with per-element
    # exponents, as the reference's do: modexp, not modexp_fixed
    check_launches("collab_encrypt_vec", enc_launches,
                   ("modexp[montgomery,win4]", "mulmod"))
    log(f"  collab_encrypt_vec: {NK} plaintexts in {enc_s:.3f} s, equal to "
        f"scalar collaborative_encrypt on {len(sample)} samples, same rng "
        f"state; launches by shape " + json.dumps(
            [{"body": b, "B": B, "k": k, "launches": n}
             for (b, B, k), n in sorted(enc_shapes.items())]))
    return res, launches, shapes, enc_launches


class _Replay:
    """Hands scalar ``collaborative_encrypt`` recorded draws: its 64-bit
    masks, then its blinding r (units, so ``rand_r`` takes each first)."""

    def __init__(self, masks, rs):
        self._masks, self._rs = iter(masks), iter(rs)

    def getrandbits(self, k):
        return next(self._masks)

    def randrange(self, lo, hi):
        return next(self._rs)


def run_families(protocol, build, workloads):
    """Each other family, gold arm at the main path's key, its spec from
    ``calibrate_spec``, every edge's block Nk = 192 (row split: model
    width 192, M rows per edge), FAMILY_ITERS iterations (the streaming
    family one more, so its first re-share runs): history equal to the
    family's plain arm.  The consensus families sum through
    ``paillier_aggregate`` on the card.  Launches are summed over the
    families."""
    total = defaultdict(int)
    shapes_total = defaultdict(int)
    out = {}
    for name in FAMILIES:
        wl = workloads.get_default(name)
        row = name in ROW_SPLIT
        inst = wl.make_instance(K * M if row else M, NK if row else N, K,
                                seed=SEED)
        iters = FAMILY_ITERS + 1 if wl.streaming else FAMILY_ITERS
        spec = wl.calibrate_spec(inst.A, inst.y, K, iters)
        cfg = protocol.ProtocolConfig(
            K=K, rho=wl.rho, lam=wl.lam, iters=iters, spec=spec,
            cipher="gold", key_bits=KEY_BITS, seed=SEED, workload=name,
            device=DEVICE)
        plain = protocol.run_protocol(inst.A, inst.y,
                                      replace(cfg, cipher="plain"),
                                      workload=wl)
        res, box, wall, launches, shapes = drive(protocol, build, inst, cfg,
                                                 workload=wl)
        assert res.history.shape == (iters, K * NK)
        assert np.all(np.isfinite(res.history))
        assert res.history.tobytes() == plain.history.tobytes(), \
            f"{name}: gold history differs from the plain arm"
        check_launches(f"{name} path", launches, MAIN_PATH_BODIES)
        for body, n in launches.items():
            total[body] += n
        for shape, n in shapes.items():
            shapes_total[shape] += n
        secs = res.stats["seconds"]
        out[name] = dict(iters=iters, delta=spec.delta, zmax=spec.zmax,
                         rounds_s=secs["rounds"], share_s=secs["share"],
                         reshare_events=res.stats["reshare_events"],
                         edge_to_master_bytes=res.stats["traffic_bytes"][
                             "edge->master"],
                         launches=launches)
        log(f"  {name}: Delta={spec.delta:g} zmax={spec.zmax:g}, rounds "
            + ", ".join(f"{t:.4f}" for t in secs["rounds"])
            + f" s, re-shares {res.stats['reshare_events']}; history equals "
            f"the plain arm; launches {launches}")
    return out, dict(total), dict(shapes_total)


def run_churn(protocol, churn_mod, build, QuantSpec, make_lasso):
    """LASSO gold under ``ChurnSchedule.quarter(K, 5)`` with recycled
    updates at Nk = 192: history equal to the plain arm under the same
    schedule."""
    inst = make_lasso(M, N, sparsity=0.1, noise=0.01, seed=SEED)
    sched = churn_mod.ChurnSchedule.quarter(K, CHURN_ITERS)
    cfg = replace(lasso_config(protocol, QuantSpec, "gold", CHURN_ITERS),
                  churn=sched, recycle=True)
    plain = protocol.run_protocol(inst.A, inst.y,
                                  replace(cfg, cipher="plain"))
    res, box, wall, launches, shapes = drive(protocol, build, inst, cfg)
    assert res.history.tobytes() == plain.history.tobytes(), \
        "churned gold history differs from the plain arm"
    churn_sec = res.stats["churn"]
    assert churn_sec["leaves"] == churn_sec["rejoins"] == 1, churn_sec
    assert churn_sec == plain.stats["churn"], (churn_sec,
                                               plain.stats["churn"])
    check_launches("churn path", launches, MAIN_PATH_BODIES)
    report_surface("churn", res, wall, launches, shapes)
    log(f"  churn: schedule {sched!r}; leaves {churn_sec['leaves']}, "
        f"rejoins {churn_sec['rejoins']}, recycled {churn_sec['recycled']}; "
        f"history equals the plain arm under the same schedule")
    return res, launches, shapes


def run_health(protocol, build, QuantSpec, make_lasso, plain_history):
    """One gold LASSO run of the main path with the health watchers on."""
    inst = make_lasso(M, N, sparsity=0.1, noise=0.01, seed=SEED)
    res, box, wall, launches, shapes = drive(
        protocol, build, inst,
        lasso_config(protocol, QuantSpec, "gold", ITERS), health=True)
    assert res.history.tobytes() == plain_history.tobytes()
    check_launches("health path", launches, MAIN_PATH_BODIES)
    h = res.stats["health"]
    assert h["counters"]["rounds"] == ITERS, h
    report_surface("health", res, wall, launches, shapes)
    log("  health: " + json.dumps(h))
    return res, launches, shapes


# ---------------------------------------------------------------------------
# the event-driven runtime: launches fused across edges, deadline mode,
# cipher="auto" dispatch and the edge_sim CLI
# ---------------------------------------------------------------------------

#: the event-driven runtime's paths, in the order they run
RUNTIME_PATHS = ("rt_gold", "rt_vec", "rt_deadline", "rt_auto")
#: the K edges' matvec rows in one fused launch
FUSED_B = K * NK * NK
#: deadline mode: edge 1 answers 10x slower than the others and sits
#: behind a slower link; the master's cutoff falls between the two
DEADLINE, BASE_S, SLOW_S, SLOW_EDGE, SLOW_LINK_S = 0.2, 0.05, 0.5, 1, 0.15
TICK_S = 1e-3
#: rows of each new launch shape held against the plain version: the
#: first and last rows of its first launch (of each half of a pair)
SAMPLE_ROWS = 4


def _host_modulus(dm):
    """A DeviceModulus's tensors on the host (for the plain versions)."""
    return type(dm)(**{f.name: (getattr(dm, f.name).cpu()
                                if isinstance(getattr(dm, f.name),
                                              torch.Tensor)
                                else getattr(dm, f.name))
                       for f in dataclasses.fields(dm)})


def _sample(B):
    """The first and last SAMPLE_ROWS of B rows."""
    n = min(SAMPLE_ROWS, B)
    return sorted({*range(n), *range(B - n, B)})


def _tree_sample(x, table, midx, corr, out, sel, impl, device="cpu"):
    """Rows ``sel`` of a product-tree launch, on ``device``: their factors
    and results, each row's modulus material as a table of its own (row i
    of every table tensor, and of the R^N correction, is sample row i's),
    the factors a row and the launch's default groups a row."""
    from repro_torch.kernels import common as cm
    from repro_torch.kernels import geometry
    idx = torch.as_tensor(sel, device=x.device)
    rows = midx[idx] if midx is not None else torch.zeros(
        len(sel), dtype=torch.int32, device=x.device)
    dm = cm.RowsModulus(table, rows, ()).per_row()
    g = geometry.tree_geometry(geometry.body_name("prod_rows", impl),
                               int(x.shape[0]), int(x.shape[1]), table.L32)
    return dict(x=x[idx].to(device), out=out[idx].to(device),
                dm=_host_modulus(dm) if device == "cpu" else dm,
                corr=None if corr is None else corr[rows.long()].to(device),
                N=int(x.shape[1]), groups=g.groups, impl=impl)


def _tree_plain(s):
    """The plain product tree of a :func:`_tree_sample`, each sample row
    under its own table row, at the launch's G."""
    from repro_torch.kernels import prodtree
    n = int(s["x"].shape[0])
    midx = torch.arange(n, dtype=torch.int32, device=s["x"].device)
    return prodtree.prod_rows_plain(s["x"], s["dm"], midx, s["impl"],
                                    s["groups"], s["corr"])


class ShapeRecorder:
    """While installed, wraps the four kernel wrappers: every launch of a
    (body, B, k) shape not in ``seen`` gets CUDA events around it, and the
    first launch of each such shape keeps sample rows of its operands and
    result on the host.  :meth:`check` then holds each sample against the
    plain version of its body on the host and returns one row per shape
    with its launches, median device ms and bound."""

    def __init__(self, mx, lm, geometry, seen):
        self.mx, self.lm, self.geometry = mx, lm, geometry
        self.seen = set(seen)
        self.events = defaultdict(list)
        self.samples = {}
        self._real = {}

    def _timed(self, shape, fn):
        if shape in self.seen:
            return fn(), False
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        stop.record()
        self.events[shape].append((start, stop))
        return out, shape not in self.samples

    def __enter__(self):
        from repro_torch.kernels import prodtree
        mx, lm, geometry = self.mx, self.lm, self.geometry
        real_modexp, real_fixed, real_mulmod, real_prod = (
            mx.modexp_cuda, mx._launch_fixed, lm.mulmod_cuda,
            prodtree.prod_rows_cuda)
        self._real = {(mx, "modexp_cuda"): real_modexp,
                      (mx, "_launch_fixed"): real_fixed,
                      (lm, "mulmod_cuda"): real_mulmod,
                      (prodtree, "prod_rows_cuda"): real_prod}

        def modexp_cuda(base, exp, dm, method, reduce_impl, tpi=None):
            body = geometry.body_name("modexp", reduce_impl, method)
            shape = (body, int(base.shape[0]), dm.L32)
            out, first = self._timed(shape, lambda: real_modexp(
                base, exp, dm, method, reduce_impl, tpi))
            if first:
                idx = _sample(shape[1])
                self.samples[shape] = dict(
                    kind="modexp", base=base[idx].cpu(), exp=exp[idx].cpu(),
                    out=out[idx].cpu(), dm=_host_modulus(dm),
                    method=method, impl=reduce_impl,
                    exp_bits=16 * int(exp.shape[1]), L16=dm.L16)
            return out

        def launch_fixed(base, B0, windows, dms, mont, tpi):
            body = geometry.body_name("modexp_fixed",
                                      "montgomery" if mont else "barrett")
            shape = (body, int(base.shape[0]), dms[0].L32)
            out, first = self._timed(shape, lambda: real_fixed(
                base, B0, windows, dms, mont, tpi))
            if first:
                halves = []
                for lo, hi, w, dm in ((0, B0, windows[0], dms[0]),
                                      (B0, shape[1], windows[-1], dms[-1])):
                    if hi > lo:
                        idx = [lo + i for i in _sample(hi - lo)]
                        halves.append((base[idx].cpu(), out[idx].cpu(),
                                       list(w), _host_modulus(dm)))
                self.samples[shape] = dict(
                    kind="modexp_fixed", halves=halves,
                    impl="montgomery" if mont else "barrett",
                    exp_bits=4 * max(len(w) for w in windows),
                    L16=dms[0].L16)
            return out

        def mulmod_cuda(a, b, dm, tpi=None):
            shape = ("mulmod", int(a.shape[0]), dm.L32)
            out, first = self._timed(shape, lambda: real_mulmod(a, b, dm,
                                                                tpi))
            if first:
                idx = _sample(shape[1])
                self.samples[shape] = dict(
                    kind="mulmod", a=a[idx].cpu(), b=b[idx].cpu(),
                    out=out[idx].cpu(), dm=_host_modulus(dm),
                    broadcast=b.shape[0] > 1 and b.stride(0) == 0,
                    L16=dm.L16)
            return out

        def prod_rows_cuda(x, table, midx, reduce_impl, corr=None, tpi=None,
                           groups=None, threads=None):
            body = geometry.body_name("prod_rows", reduce_impl)
            shape = (body, int(x.shape[0]), table.L32)
            out, first = self._timed(shape, lambda: real_prod(
                x, table, midx, reduce_impl, corr, tpi, groups, threads))
            if first:
                self.samples[shape] = dict(
                    kind="prod_rows", L16=table.L16, **_tree_sample(
                        x, table, midx, corr, out, _sample(shape[1]),
                        reduce_impl))
            return out

        mx.modexp_cuda, mx._launch_fixed, lm.mulmod_cuda = (
            modexp_cuda, launch_fixed, mulmod_cuda)
        prodtree.prod_rows_cuda = prod_rows_cuda
        return self

    def __exit__(self, *exc):
        for (mod, attr), fn in self._real.items():
            setattr(mod, attr, fn)
        return False

    def _fixed_plain(self):
        """The plain ``modexp_fixed`` of every sampled half, one call per
        (reduction, exponent, modulus): the 2,048-bit ladders cost seconds
        a call on the host whatever the rows, and launches of two shapes
        (the share phase's and a round's encryptions) share exponent and
        moduli.  Returns {(shape, half): rows} and the seconds per call."""
        groups = defaultdict(list)
        for shape, s in self.samples.items():
            if s["kind"] != "modexp_fixed":
                continue
            for h, (base, _, w, dm) in enumerate(s["halves"]):
                key = (s["impl"], tuple(w), dm.m16.numpy().tobytes())
                groups[key].append((shape, h, base, dm))
        want, secs = {}, []
        for (impl, w, _), items in groups.items():
            t0 = time.perf_counter()
            out = self.mx.modexp_fixed_plain(
                torch.cat([base for _, _, base, _ in items]), list(w),
                items[0][3], impl)
            secs.append(time.perf_counter() - t0)
            i = 0
            for shape, h, base, _ in items:
                want[(shape, h)] = out[i:i + base.shape[0]]
                i += base.shape[0]
        return want, secs

    def check(self):
        torch.cuda.synchronize()
        mx, lm = self.mx, self.lm
        fixed_want, fixed_secs = self._fixed_plain()
        log(f"  plain modexp_fixed on the host for the sampled rows: "
            f"{len(fixed_secs)} calls, "
            + ", ".join(f"{t:.1f}" for t in fixed_secs) + " s")
        rows = []
        for shape in sorted(self.samples):
            body, B, k = shape
            s = self.samples[shape]
            t0 = time.perf_counter()
            if s["kind"] == "modexp":
                got = [s["out"]]
                want = [mx.modexp_plain(s["base"], s["exp"], s["dm"],
                                        s["method"], s["impl"])]
                work = word_products("modexp", k, exp_bits=s["exp_bits"],
                                     mont=s["impl"] == "montgomery",
                                     win4=s["method"] == "win4")
                moved = B * (2 * s["L16"] + s["exp_bits"] // 16) * 4
            elif s["kind"] == "modexp_fixed":
                got = [out for _, out, _, _ in s["halves"]]
                want = [fixed_want[(shape, h)] for h in range(len(got))]
                work = word_products("modexp_fixed", k,
                                     exp_bits=s["exp_bits"],
                                     mont=s["impl"] == "montgomery")
                moved = B * 2 * s["L16"] * 4
            elif s["kind"] == "prod_rows":
                got = [s["out"]]
                want = [_tree_plain(s)]
                work = word_products("prod_rows", k, factors=s["N"])
                moved = B * (s["N"] + 1) * s["L16"] * 4
            else:
                got = [s["out"]]
                want = [lm.mulmod_plain(s["a"], s["b"], s["dm"])]
                work = word_products("mulmod", k)
                moved = B * (2 + (0 if s["broadcast"] else 1)) \
                    * s["L16"] * 4
            plain_ms = None if s["kind"] == "modexp_fixed" \
                else 1e3 * (time.perf_counter() - t0)
            err = max(int((g.long() - w.long()).abs().max()) if g.numel()
                      else 0 for g, w in zip(got, want))
            assert err == 0, f"{shape}: kernel differs from its plain " \
                f"version on sample rows (max abs limb error {err})"
            ms = [a.elapsed_time(b) for a, b in self.events[shape]]
            bnd, by = bound_ms(work, B, moved)
            rows.append(dict(body=body, B=B, k=k,
                             launches=len(self.events[shape]),
                             ms=float(np.median(ms)), ms_max=max(ms),
                             bound_ms=bnd, bound_by=by,
                             sample_rows=sum(int(g.shape[0]) for g in got),
                             max_abs_err=err,
                             plain_host_ms_on_sample=plain_ms))
        return rows


def drive_runtime(build, run):
    """One runtime run with the launch counts set to 0 just before it and
    read just after; returns the result, wall seconds and the launches by
    body and by shape."""
    build.reset_launches()
    t0 = time.perf_counter()
    res = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return res, wall, dict(build.LAUNCHES), dict(build.SHAPE_LAUNCHES)


def report_runtime(path, res, wall, launches, shapes):
    secs, rt = res.stats["seconds"], res.stats["runtime"]
    done = rt["iter_times"]
    virt = [b - a for a, b in zip(done, done[1:])]
    log(f"  {path}: wall {wall:.2f} s; init {secs['init']:.3f} s, share "
        f"{secs['share']:.3f} s, rounds (wall) "
        + ", ".join(f"{t:.4f}" for t in secs["rounds"]) + " s; rounds "
        "(virtual, completion times) "
        + ", ".join(f"{t:.4f}" for t in done) + " s, between rounds "
        + ", ".join(f"{t:.4f}" for t in virt) + " s")
    log(f"  {path}: coalesce launches {rt['launches']}, coalesced ops "
        f"{rt['coalesced_ops']}, held flushes {rt['held_flushes']}, ops "
        f"per launch {json.dumps(rt['coalesce']['ops_per_launch'])}; "
        f"launch wall ms (device synchronized) "
        + json.dumps({op: {k: round(v.get('p50', 0.0), 3)
                           for k, v in d.items()}
                      for op, d in rt["coalesce"]["launch_wall_ms"].items()}))
    log(f"  {path} launches {launches}; by shape " + json.dumps(
        [{"body": body, "B": B, "k": k, "launches": n}
         for (body, B, k), n in sorted(shapes.items())]))


def run_runtime_sync(runner, protocol, QuantSpec, make_lasso, report_core,
                     build, cipher, plain_history, sync_core):
    """``run_on_runtime`` on a star at the main path's cut: history equal
    to the plain arm's, RunReport core equal to the synchronous run of
    the same arm; the K edges' matvecs fused into one launch per CRT half
    (gold) or one n^2 launch (vec) per round, one ``modexp_fixed`` launch
    for the round's encryptions and one for its decryptions."""
    inst = make_lasso(M, N, sparsity=0.1, noise=0.01, seed=SEED)
    cfg = lasso_config(protocol, QuantSpec, cipher, ITERS)
    res, wall, launches, shapes = drive_runtime(
        build, lambda: runner.run_on_runtime(inst.A, inst.y, cfg,
                                             device=DEVICE))
    path = f"runtime {cipher} arm"
    assert res.history.tobytes() == plain_history.tobytes(), \
        f"{path}: history differs from the plain arm"
    assert report_core(res.stats) == sync_core, \
        f"{path}: RunReport core differs from the synchronous run's"
    check_launches(path, launches, MAIN_PATH_BODIES)
    body = "modexp[montgomery,win4]"
    k = (KEY_BITS if cipher == "gold" else 2 * KEY_BITS) // 32
    per_round = 2 if cipher == "gold" else 1
    fused = shapes.get((body, FUSED_B, k), 0)
    assert fused == per_round * ITERS, \
        f"{path}: {fused} fused modexp launches at B={FUSED_B}, k={k}; " \
        f"expected {per_round} per round"
    assert launches[body] == fused, \
        f"{path}: modexp launched outside the fused matvec: {launches}"
    assert launches["modexp_fixed[montgomery]"] == 1 + 2 * ITERS, \
        f"{path}: modexp_fixed launches {launches}; expected one for the " \
        f"share phase and two per round"
    report_runtime(path, res, wall, launches, shapes)
    return res, launches, shapes


def run_runtime_deadline(runner, protocol, QuantSpec, make_lasso, LinkModel,
                         build):
    """Deadline mode, gold arm: edge SLOW_EDGE answers 10x slower behind a
    slower link, the coalescing queue holds lone ops
    (``coalesce_hold_ticks="auto"``), so ops of different rounds share
    launches.  Held against the plain arm under the same schedule (links
    of infinite bandwidth: ciphertext size cannot move an event): equal
    history, equal nonzero stale events, equal virtual round times."""
    inst = make_lasso(M, N, sparsity=0.1, noise=0.01, seed=SEED)
    inf = float("inf")
    kw = dict(link=LinkModel(bytes_per_s=inf),
              per_link={("master", f"edge{SLOW_EDGE}"): LinkModel(
                  bytes_per_s=inf, latency_s=SLOW_LINK_S)},
              coalesce_hold_ticks="auto", tick_s=TICK_S, device=DEVICE)
    cfg = replace(lasso_config(protocol, QuantSpec, "gold", ITERS),
                  deadline=DEADLINE,
                  latency_fn=lambda k, t: SLOW_S if k == SLOW_EDGE
                  else BASE_S)
    plain = runner.run_on_runtime(inst.A, inst.y,
                                  replace(cfg, cipher="plain"), **kw)
    res, wall, launches, shapes = drive_runtime(
        build, lambda: runner.run_on_runtime(inst.A, inst.y, cfg, **kw))
    assert res.stale_events == plain.stale_events > 0, \
        (res.stale_events, plain.stale_events)
    assert res.history.tobytes() == plain.history.tobytes(), \
        "deadline run: history differs from its plain twin"
    assert res.stats["runtime"]["iter_times"] == \
        plain.stats["runtime"]["iter_times"]
    check_launches("runtime deadline path", launches, MAIN_PATH_BODIES)
    rt = res.stats["runtime"]
    assert rt["held_flushes"] > 0, rt["held_flushes"]
    report_runtime("runtime deadline (gold)", res, wall, launches, shapes)
    log(f"  deadline: {res.stale_events} stale blocks (plain twin "
        f"{plain.stale_events}), hold {rt['coalesce_hold_ticks']} ticks; "
        f"history equals the plain twin bit for bit")
    return res, launches, shapes


def run_runtime_auto(runner, dispatch, protocol, QuantSpec, make_lasso,
                     build, plain_history, calib):
    """``cipher="auto"``: calibrate on the card into a fresh cache file,
    then run with that cache (loaded, nothing measured); history equal
    to the plain arm's."""
    if os.path.exists(calib):
        os.remove(calib)
    t0 = time.perf_counter()
    table = dispatch.calibrate(key_bits=(KEY_BITS,), batch_sizes=(NK,),
                               backends=("gold", "gold_batch", "vec"),
                               path=calib, device=DEVICE)
    calib_s = time.perf_counter() - t0
    log(f"  calibrate: {calib_s:.1f} s on {dispatch.device_kind(DEVICE)}; "
        f"seconds per element " + json.dumps(table["entries"]))
    inst = make_lasso(M, N, sparsity=0.1, noise=0.01, seed=SEED)
    cfg = lasso_config(protocol, QuantSpec, "auto", ITERS)
    res, wall, launches, shapes = drive_runtime(
        build, lambda: runner.run_on_runtime(inst.A, inst.y, cfg,
                                             calib_path=calib,
                                             device=DEVICE))
    assert res.history.tobytes() == plain_history.tobytes(), \
        "auto run: history differs from the plain arm"
    # the run's own calibrate call is the last one its report drained
    loads = [e for e in res.stats["runtime"]["profile"]
             if e["kind"] == "calibrate"]
    assert loads and loads[-1]["measured"] == 0 \
        and loads[-1]["cached"] == 3, loads
    check_launches("runtime auto path", launches, MAIN_PATH_BODIES)
    routes = res.stats["runtime"]["dispatch"]
    report_runtime("runtime auto", res, wall, launches, shapes)
    log(f"  auto: routes {json.dumps(routes)}; the run loaded the cache "
        f"({json.dumps(loads[-1])}); history equals the plain arm")
    return res, launches, shapes, calib_s, routes


def run_edge_sim(calib):
    """``python -m repro_torch.launch.edge_sim --backend auto`` as a
    subprocess at the main path's key and block width, loading the
    calibration cache ``calib``; returns its wall seconds."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               REPRO_CALIB_CACHE=calib)
    cmd = [sys.executable, "-m", "repro_torch.launch.edge_sim", "--backend",
           "auto", "--edges", str(K), "--block", str(NK), "--key-bits",
           str(KEY_BITS), "--iters", str(ITERS)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          env=env, cwd=REPO)
    secs = time.perf_counter() - t0
    assert proc.returncode == 0, \
        f"edge_sim exited {proc.returncode}:\n{proc.stderr[-4000:]}"
    summary = json.loads(proc.stdout)
    assert summary["backend"] == "auto" and summary["iters"] == ITERS
    assert summary["device"] == f"torch-cuda-" + \
        torch.cuda.get_device_name(0).replace("/", "-")
    log(f"  edge_sim: exit 0 in {secs:.1f} s; summary "
        + json.dumps(summary, separators=(",", ":")))
    return secs


# ---------------------------------------------------------------------------
# the serving path: ProtocolEngine, the rows kernels, serve_sim, the CLIs
# ---------------------------------------------------------------------------

SERVE_PATHS = ("serve_s1", "serve_s2")
#: the per-row-modulus bodies S1 launches (the binary ladder runs only
#: under REPRO_MODEXP_METHOD=binary, the Barrett modexp_rows bodies under
#: REPRO_REDUCE_IMPL=barrett or for an even modulus, the other Barrett
#: bodies for an even modulus only)
SERVE_BODIES = ("mulmod_rows[montgomery]", "modexp_rows[montgomery,win4]",
                "prod_rows[montgomery]")
BARRETT_ROWS_BODIES = ("mulmod_rows[barrett]", "modexp_rows[barrett,win4]",
                       "modexp_rows[barrett,binary]", "prod_rows[barrett]")
SERVE_ITERS = 2
SERVE_SEEDS = (0, 1, 2, 3)
#: S2's second key width
SERVE_SMALL_BITS = 1024
#: S2: virtual seconds by which one tenant's admission is staggered
STAGGER_S = 0.05
#: the rows bodies timed beside their plain versions: rows, moduli
ROWS_TIMED_B, ROWS_MODULI = 4608, 4


def rows_body(body):
    """(reduce_impl, method) of a ``modexp_rows[...]`` body."""
    impl, method = body[len("modexp_rows["):-1].split(",")
    return impl, method


def cat_moduli(dms):
    """Per-row DeviceModuli (``RowsModulus.per_row``) stacked row-wise."""
    return replace(dms[0], **{
        f.name: torch.cat([getattr(d, f.name) for d in dms])
        for f in dataclasses.fields(dms[0])
        if isinstance(getattr(dms[0], f.name), torch.Tensor)})


def mulmod_rows_instantiation(body, g):
    """The ``mulmod_rows_kernel`` instantiation a launch geometry runs."""
    return (f"mulmod_rows_kernel<{g.tpi},{g.words},"
            f"{str(body.endswith('[montgomery]')).lower()}>")


def rows_instantiation(body, g):
    """The ``modexp_rows_kernel`` instantiation a launch geometry runs."""
    impl, method = rows_body(body)
    return (f"modexp_rows_kernel<{g.tpi},{g.words},"
            f"{str(method == 'win4').lower()},"
            f"{str(impl == 'montgomery').lower()}>")


def time_rows_kernels(bi, ops, lm, mx, geometry, ptxas, dev):
    """Each per-row-modulus body at k = 128 (n^2 of a 2,048-bit key),
    B = ROWS_TIMED_B rows over ROWS_MODULI moduli, 64-bit exponents (the
    matvec's): the kernel timed beside its plain version on the same
    inputs (on the card), the two held against each other and against
    Python ints on a sample.  Returns {body: row}."""
    rng = random.Random(SEED + 5)
    ms = [rng.getrandbits(4096) | (1 << 4095) | 1 for _ in range(ROWS_MODULI)]
    B = ROWS_TIMED_B
    per_row = [ms[i % ROWS_MODULI] for i in range(B)]
    rm = ops.rows_modulus(per_row, 512, dev)
    L16 = rm.table.L16

    def rows(n, L):
        ints = [rng.getrandbits(16 * L) for _ in range(n)]
        return ints, torch.as_tensor(bi.from_ints(ints, L), device=dev)

    a, at = rows(B, L16)
    b, bt = rows(B, L16)
    e, et = rows(B, 4)
    out = {}
    cases = [
        (f"mulmod_rows[{impl}]", "mulmod_rows_kernel",
         functools.partial(lm.mulmod_rows_cuda, at, bt, rm, impl),
         functools.partial(lm.mulmod_rows_plain, at, bt, rm, impl),
         [x * y % m for x, y, m in zip(a[:4], b[:4], per_row)],
         word_products("mulmod", 128), B * 3 * L16 * 4, 0, 20)
        for impl in ("montgomery", "barrett")]
    for body in ("modexp_rows[barrett,win4]", "modexp_rows[barrett,binary]",
                 "modexp_rows[montgomery,win4]",
                 "modexp_rows[montgomery,binary]"):
        impl, method = rows_body(body)
        cases.append((
            body, "modexp_rows_kernel",
            functools.partial(mx.modexp_rows_cuda, at, et, rm, method, impl),
            functools.partial(mx.modexp_rows_plain, at, et, rm, method,
                              impl),
            [pow(x, y, m) for x, y, m in zip(a[:4], e[:4], per_row)],
            word_products("modexp", 128, exp_bits=64,
                          mont=impl == "montgomery", win4=method == "win4"),
            B * (2 * L16 + 4) * 4, 64, 5))
    for name, symbol, kernel, plain, want, work, nbytes, exp_bits, reps \
            in cases:
        ms_, event_ms, got = kernel_ms(kernel, reps, symbol)
        plain_ms, ref = once_ms(plain)
        err = compare(bi, name, got, ref, want)
        bnd, by = bound_ms(work, B, nbytes + B * 4)
        g = geometry.launch_geometry(name, B, 128)
        inst_name = mulmod_rows_instantiation(name, g) \
            if name.startswith("mulmod_rows") else rows_instantiation(name, g)
        regs = ptxas.get(inst_name, {})
        check_spills(inst_name, regs)
        out[name] = dict(shape=f"B={B} k=128 over {ROWS_MODULI} moduli"
                         + (f", {exp_bits}-bit exps" if exp_bits else ""),
                         B=B, k=128, ms=ms_, event_ms=event_ms,
                         plain_ms=plain_ms, max_abs_err=err, bound_ms=bnd,
                         bound_by=by, instantiation=inst_name, **regs)
        log(f"  {name} B={B} k=128 ({inst_name}: {regs.get('registers')} "
            f"registers, {regs.get('stack')} B stack, "
            f"{regs.get('spill_stores')} B spills): {ms_:.4f} ms on the "
            f"device, {event_ms:.4f} ms per call (plain {plain_ms:.1f} ms, "
            f"bound {bnd:.4f} ms), equal")
    return out


#: S1's and S2's per-row products (a round's sums and the blinding
#: product of its encryptions): rows at k = 64 (n^2 of a 1,024-bit key)
#: and 128 (2,048 bits) over four tenants; the main path's ``mulmod``
#: shapes (an edge's matvec reduced into p^2, the sums) for the
#: one-modulus comparison
S1_MULMOD_SHAPES = tuple((B, k) for k in (64, 128)
                         for B in (576, 1152, 2304, 4608))
MAIN_MULMOD_SHAPES = ((36864, 64), (192, 64), (192, 128))
MULMOD_ROWS_BODIES = ("mulmod_rows[barrett]", "mulmod_rows[montgomery]")
#: the block sizes the mulmod_rows sweep times
MULMOD_SWEEP_THREADS = (64, 128, 256)
#: GPU cycles a timed burst waits behind (about 20 ms at 1.98 GHz), so
#: every call of it is queued before the first runs
SLEEP_CYCLES = 40_000_000


def queued_ms(fn, reps):
    """Device milliseconds per call of ``fn`` with the host's enqueue
    hidden (CUDA events around ``reps`` calls queued behind a
    ``torch.cuda._sleep``), the host's wall milliseconds per call (the
    wrapper's own time: it must not wait for the device), whether the
    burst was queued within the sleep, and the result of a warm-up
    call."""
    result = fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    torch.cuda._sleep(SLEEP_CYCLES)
    ev[1].record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    wall = 1e3 * (time.perf_counter() - t0)
    ev[2].record()
    torch.cuda.synchronize()
    return (ev[1].elapsed_time(ev[2]) / reps, wall / reps,
            wall < ev[0].elapsed_time(ev[1]), result)


def time_mulmod_rows_s1(bi, ops, lm, geometry, ptxas, dev):
    """Both ``mulmod_rows`` bodies at S1's and S2's shapes
    (``S1_MULMOD_SHAPES``, four odd moduli, each tenant's rows together,
    operands up to 2^{32k} - 1) in turns (Barrett, Montgomery, Montgomery,
    Barrett; ``queued_ms``), equal to each other on every row and to the
    plain version (card) and Python ints on SAMPLE_ROWS first and last
    rows; the sweep of both bodies' group and block sizes, each output
    equal; and the Montgomery body on a one-modulus table in turns with
    ``mulmod`` at the same shapes and ``MAIN_MULMOD_SHAPES``.  Returns
    (turn rows, sweep rows, one-modulus rows)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 8)
    rng = random.Random(SEED + 8)
    turns, sweep, single = [], [], []
    for B, k in S1_MULMOD_SHAPES + MAIN_MULMOD_SHAPES:
        ms = [rng.getrandbits(32 * k) | (1 << (32 * k - 1)) | 1
              for _ in range(len(SERVE_SEEDS))]
        T = len(ms)
        one = ops.rows_modulus([ms[0]] * B, 4 * k, dev)
        L16 = one.table.L16
        a, b = (torch.randint(0, 1 << 16, (B, L16), generator=gen,
                              device=dev, dtype=torch.int32)
                for _ in range(2))
        reps = 20
        bnd, by = bound_ms(word_products("mulmod", k), B,
                           B * 3 * L16 * 4 + B * 4)
        sel = _sample(B)
        sel_t = torch.as_tensor(sel, device=dev)
        if (B, k) in S1_MULMOD_SHAPES:
            per_row = [ms[i * T // B] for i in range(B)]
            rm = ops.rows_modulus(per_row, 4 * k, dev)
            shape = dict(B=B, k=k, moduli=T, bound_ms=bnd, bound_by=by)
            want = [x * y % per_row[i] for i, x, y in zip(
                sel, bi.to_ints(a[sel_t].cpu()), bi.to_ints(b[sel_t].cpu()))]
            sample = replace(rm, midx=rm.midx[sel_t])
            times, walls, results = defaultdict(list), defaultdict(list), {}
            for body in MULMOD_ROWS_BODIES + MULMOD_ROWS_BODIES[::-1]:
                impl = body[len("mulmod_rows["):-1]
                t, w, hidden, results[body] = queued_ms(functools.partial(
                    lm.mulmod_rows_cuda, a, b, rm, impl), reps)
                assert hidden, f"{body} B={B} k={k}: burst not hidden"
                times[body].append(t)
                walls[body].append(w)
            assert torch.equal(*results.values()), (B, k)
            for body in MULMOD_ROWS_BODIES:
                impl = body[len("mulmod_rows["):-1]
                plain_ms, plain = once_ms(functools.partial(
                    lm.mulmod_rows_plain, a[sel_t], b[sel_t], sample, impl))
                err = compare(bi, f"{body} B={B} k={k}",
                              results[body][sel_t], plain, want)
                g = geometry.launch_geometry(body, B, k)
                inst = mulmod_rows_instantiation(body, g)
                regs = ptxas.get(inst, {})
                check_spills(inst, regs)
                row = dict(body=body, **shape, ms=float(np.mean(times[body])),
                           turns_ms=times[body],
                           wall_ms=float(np.mean(walls[body])),
                           plain_ms=plain_ms, plain_rows=len(sel),
                           max_abs_err=err, tpi=g.tpi, threads=g.threads,
                           instantiation=inst, **regs)
                turns.append(row)
                log(f"  {body} B={B} k={k} over {T} moduli ({inst}, "
                    f"{g.threads} threads: {regs.get('registers')} "
                    f"registers, {regs.get('spill_stores')} B spills): "
                    f"{row['ms']:.4f} ms on the device (turns " + ", ".join(
                        f"{t:.4f}" for t in times[body]) + f"), "
                    f"{row['wall_ms']:.4f} ms wall a call on the host, "
                    f"bound {bnd:.5f} ms; equal to the other body, the "
                    f"plain version and Python ints")
            for body in MULMOD_ROWS_BODIES:
                impl = body[len("mulmod_rows["):-1]
                best = None
                for tpi in sorted({t for t, _ in geometry.SHAPES[body]}):
                    for threads in MULMOD_SWEEP_THREADS:
                        g = geometry.launch_geometry(body, B, k, tpi,
                                                     threads)
                        t, w, _, got = queued_ms(functools.partial(
                            lm.mulmod_rows_cuda, a, b, rm, impl, tpi=tpi,
                            threads=threads), 10)
                        assert torch.equal(got, results[body]), (
                            body, B, k, tpi, threads)
                        inst = mulmod_rows_instantiation(body, g)
                        regs = ptxas.get(inst, {})
                        check_spills(inst, regs)
                        smem_int, regs_int = resident_integers(
                            g, regs.get("registers", 0))
                        row = dict(body=body, B=B, k=k, tpi=tpi,
                                   threads=threads, ms=t, wall_ms=w,
                                   bound_ms=bnd,
                                   registers=regs.get("registers"),
                                   resident_by_regs=regs_int,
                                   default=g == geometry.launch_geometry(
                                       body, B, k))
                        sweep.append(row)
                        best = row if best is None or t < best["ms"] \
                            else best
                log(f"  sweep {body} B={B} k={k}: fastest TPI {best['tpi']}"
                    f" x {best['threads']} threads {best['ms']:.4f} ms; "
                    "TPI/threads ms: " + ", ".join(
                        f"{r['tpi']}/{r['threads']} {r['ms']:.4f}"
                        for r in sweep if r["body"] == body
                        and (r["B"], r["k"]) == (B, k)))
            del results
        # the Montgomery body on one modulus beside mulmod, in turns
        dm = ops.pack_modulus(ms[0]).on(dev)
        runs = {"mulmod": functools.partial(lm.mulmod_cuda, a, b, dm),
                "mulmod_rows[montgomery]": functools.partial(
                    lm.mulmod_rows_cuda, a, b, one, "montgomery")}
        times, walls, results = defaultdict(list), defaultdict(list), {}
        for name in ("mulmod", "mulmod_rows[montgomery]",
                     "mulmod_rows[montgomery]", "mulmod"):
            t, w, hidden, results[name] = queued_ms(runs[name], reps)
            assert hidden, f"{name} B={B} k={k}: burst not hidden"
            times[name].append(t)
            walls[name].append(w)
        assert torch.equal(*results.values()), (B, k)
        assert bi.to_ints(results["mulmod"][sel_t].cpu()) == [
            x * y % ms[0] for x, y in zip(bi.to_ints(a[sel_t].cpu()),
                                          bi.to_ints(b[sel_t].cpu()))]
        row = dict(B=B, k=k, bound_ms=bnd, bound_by=by, **{
            f"{name}_{key}": float(np.mean(v[name]))
            for name in runs for key, v in (("ms", times), ("wall_ms", walls))})
        single.append(row)
        log(f"  one modulus B={B} k={k}: mulmod "
            f"{row['mulmod_ms']:.4f} ms, the Montgomery rows body "
            f"{row['mulmod_rows[montgomery]_ms']:.4f} ms on the device "
            f"(turns " + ", ".join(f"{t:.4f}" for t in times["mulmod"])
            + " / " + ", ".join(
                f"{t:.4f}" for t in times["mulmod_rows[montgomery]"])
            + f"); bound {bnd:.5f} ms; equal")
        del results, a, b
    torch.cuda.empty_cache()
    return turns, sweep, single


#: S1's per-row ModExp launches at n^2 over its tenants: (what, rows,
#: exponent bits): the fused matvec (every tenant's K Nk x Nk blocks),
#: a round's encryptions (r^n, 2 K Nk a tenant) and decryptions (c^lam,
#: K Nk a tenant)
S1_ROWS_SHAPES = (("matvec", len(SERVE_SEEDS) * K * NK * NK, 64),
                  ("enc", len(SERVE_SEEDS) * 2 * K * NK, 2048),
                  ("dec", len(SERVE_SEEDS) * K * NK, 2048))
#: the bodies timed in turns at each S1 shape (Barrett, Montgomery,
#: Montgomery, Barrett), and the bodies swept over group and block size
#: (the binary one at the matvec's 64-bit exponents only)
S1_TURNS = ("modexp_rows[barrett,win4]", "modexp_rows[montgomery,win4]")
S1_SWEPT = ("modexp_rows[montgomery,win4]", "modexp_rows[montgomery,binary]")
#: an SM of this card: 64K registers (allocated 256 a warp at a time),
#: 2,048 threads, 32 blocks, 228 KB of shared memory less 1 KB a block
SM_REGS, SM_THREADS, SM_BLOCKS, SM_SMEM = 65536, 2048, 32, 228 * 1024


def resident_integers(g, registers):
    """Integers resident on one SM at launch geometry ``g``, limited by
    shared memory and by registers (each with the thread and block
    limits)."""
    other = min(SM_BLOCKS, SM_THREADS // g.threads)
    by_smem = min(other, SM_SMEM // (g.smem + 1024)) if g.smem else other
    warp_regs = -(-registers * 32 // 256) * 256
    by_regs = min(other, SM_REGS // (warp_regs * (g.threads // 32)))
    return by_smem * g.per_block, by_regs * g.per_block


def time_rows_s1(bi, ops, mx, geometry, ptxas, dev):
    """The per-row ModExp at S1's three shapes (``S1_ROWS_SHAPES``, k =
    128 over the four tenants' moduli, each tenant's rows together): the
    Barrett and Montgomery win4 bodies timed in turns (CUDA events), each
    held against its plain version (on the card) and Python ints on the
    first and last SAMPLE_ROWS rows; then every group size and block size
    of the Montgomery bodies (``geometry.SWEEP_THREADS``), each output
    equal to the chosen geometry's, with its resident integers per SM by
    shared memory and by registers.  Returns (turn rows, sweep rows)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 7)
    rng = random.Random(SEED + 7)
    T = len(SERVE_SEEDS)
    ms = [rng.getrandbits(4096) | (1 << 4095) | 1 for _ in range(T)]
    turns, sweep = [], []
    for what, B, exp_bits in S1_ROWS_SHAPES:
        per_row = [ms[i * T // B] for i in range(B)]
        rm = ops.rows_modulus(per_row, 512, dev)
        L16, le16 = rm.table.L16, exp_bits // 16
        base = torch.randint(0, 1 << 16, (B, L16), generator=gen,
                             device=dev, dtype=torch.int32)
        exp = torch.randint(0, 1 << 16, (B, le16), generator=gen,
                            device=dev, dtype=torch.int32)
        sel = _sample(B)
        sel_t = torch.as_tensor(sel, device=dev)
        want = [pow(x, y, per_row[i]) for i, x, y in zip(
            sel, bi.to_ints(base[sel_t].cpu()), bi.to_ints(exp[sel_t].cpu()))]
        sample_dm = replace(rm, midx=rm.midx[sel_t]).per_row()
        reps = 1 if B > 100_000 else 2
        moved = B * (2 * L16 + le16) * 4 + B * 4
        shape = dict(what=what, B=B, k=128, exp_bits=exp_bits, moduli=T)

        def launch(body, **geom):
            impl, method = rows_body(body)
            return functools.partial(mx.modexp_rows_cuda, base, exp, rm,
                                     method, impl, **geom)

        times, results = defaultdict(list), {}
        for body in S1_TURNS + S1_TURNS[::-1]:
            t, results[body] = time_ms(launch(body), reps)
            times[body].append(t)
        for body in S1_TURNS:
            impl, method = rows_body(body)
            plain_ms, plain = once_ms(functools.partial(
                mx.modexp_plain, base[sel_t], exp[sel_t], sample_dm, method,
                impl))
            err = compare(bi, f"{body} {what}", results[body][sel_t], plain,
                          want)
            bnd, by = bound_ms(word_products(
                "modexp", 128, exp_bits, mont=impl == "montgomery",
                win4=method == "win4"), B, moved)
            g = geometry.launch_geometry(body, B, 128)
            inst = rows_instantiation(body, g)
            regs = ptxas.get(inst, {})
            check_spills(inst, regs)
            row = dict(body=body, **shape, ms=float(np.mean(times[body])),
                       turns_ms=times[body], bound_ms=bnd, bound_by=by,
                       plain_ms=plain_ms, plain_rows=len(sel),
                       max_abs_err=err, instantiation=inst, **regs)
            turns.append(row)
            log(f"  {body} {what} B={B} k=128 {exp_bits}-bit exps ({inst}: "
                f"{regs.get('registers')} registers, {regs.get('spill_stores')}"
                f" B spills): {row['ms']:.2f} ms (turns " + ", ".join(
                    f"{t:.2f}" for t in times[body]) + f"), bound "
                f"{bnd:.2f} ms, plain {plain_ms:.1f} ms on {len(sel)} rows; "
                f"equal to the plain version and Python ints")
        chosen = results["modexp_rows[montgomery,win4]"]
        for body in S1_SWEPT:
            if body.endswith("binary]") and what != "matvec":
                continue
            impl, method = rows_body(body)
            bnd = bound_ms(word_products(
                "modexp", 128, exp_bits, mont=True, win4=method == "win4"),
                B, moved)[0]
            best = None
            for tpi in sorted({t for t, _ in geometry.SHAPES[body]}):
                for threads in geometry.SWEEP_THREADS:
                    g = geometry.launch_geometry(body, B, 128, tpi, threads)
                    t, got = time_ms(launch(body, tpi=tpi, threads=threads),
                                     reps)
                    assert torch.equal(got, chosen), (body, what, tpi,
                                                      threads)
                    del got
                    inst = rows_instantiation(body, g)
                    regs = ptxas.get(inst, {})
                    check_spills(inst, regs)
                    smem_int, regs_int = resident_integers(
                        g, regs.get("registers", 0))
                    row = dict(body=body, **shape, tpi=tpi, threads=threads,
                               ms=t, bound_ms=bnd, smem_bytes=g.smem,
                               resident_by_smem=smem_int,
                               resident_by_regs=regs_int,
                               registers=regs.get("registers"),
                               default=(g == geometry.launch_geometry(
                                   body, B, 128)))
                    sweep.append(row)
                    best = row if best is None or t < best["ms"] else best
                    log(f"  sweep {body} {what} B={B}: TPI {tpi} x {threads}"
                        f" threads: {t:.2f} ms (bound {bnd:.2f}); "
                        f"{regs.get('registers')} registers, {g.smem} B "
                        f"shared a block; resident integers per SM by shared"
                        f" memory {smem_int}, by registers {regs_int}; equal")
            log(f"  sweep {body} {what}: fastest TPI {best['tpi']} x "
                f"{best['threads']} threads, {best['ms']:.2f} ms")
        del results, chosen, base, exp
        torch.cuda.empty_cache()
    return turns, sweep


def tree_levels(n):
    """The batch of each level of the tree of mulmods the product-tree
    kernel replaced, per row (n/2 products, an odd one carried)."""
    levels = []
    while n > 1:
        h = n // 2
        levels.append(h)
        n = h + (n % 2)
    return levels


def mulmod_tree(ops, x, rm=None, pack=None):
    """The product over axis 1 as the port ran it before the product-tree
    kernel (the reference's ``ops.prod_rows`` and ``paillier_vec.mul_tree``
    trees): one ``mulmod_rows`` launch a level under the per-row moduli
    ``rm``, or one ``mulmod`` launch a level under ``pack``; rebuilt from
    the public ops, the yardstick of the kernel."""
    R, n, L = x.shape
    cur = x
    while n > 1:
        h = n // 2
        a = cur[:, :h].reshape(R * h, L)
        b = cur[:, h:2 * h].reshape(R * h, L)
        prod = (ops.mulmod_rows(a, b, rm.repeat(h)) if rm is not None
                else ops.mulmod(a, b, pack)).reshape(R, h, L)
        if n % 2:
            cur = torch.cat([prod, cur[:, n - 1:n]], dim=1)
            n = h + 1
        else:
            cur, n = prod, h
    return cur[:, 0]


#: the product tree's shapes at n^2 (k = 128): (what, rows, factors a
#: row, moduli, with an even modulus): S1's fused matvec over its tenants,
#: the main path's edge matvec and the runtime's fused matvec of K edges
#: (one modulus each, ``paillier_vec.mul_tree``), and a table with an even
#: modulus (the Barrett body only)
TREE_SHAPES = (("S1", len(SERVE_SEEDS) * K * NK, NK, len(SERVE_SEEDS), False),
               ("main", NK, NK, 1, False),
               ("runtime", K * NK, NK, 1, False),
               ("even", NK, NK, len(SERVE_SEEDS), True))
#: the sweep: threads per integer, groups a row (each in a block of one
#: row and of at least 128 threads)
TREE_SWEEP_TPI = (8, 16, 32)
TREE_SWEEP_GROUPS = (1, 2, 4, 8, 16, 32, 64, 128)


def tree_instantiation(body, g):
    return (f"prod_rows_kernel<{g.tpi},{g.words},"
            f"{str(body.endswith('[montgomery]')).lower()}>")


def time_prod_rows(bi, ops, geometry, ptxas, dev):
    """The product-tree kernel at ``TREE_SHAPES``: both bodies (Barrett
    alone on the even table) timed by CUDA events in turns with the tree
    of mulmods it replaced (old, bodies, bodies reversed, old) on the same
    inputs, full-width factors (up to 2^4096 - 1); every body's output
    equal to the old tree's on every row, and to its plain version (on
    the card) and Python ints on SAMPLE_ROWS first and last rows.  Then
    the sweep of (TPI, G, threads) of both bodies at the odd shapes, each
    output equal to the default geometry's.  Returns (rows, sweep)."""
    from repro_torch.kernels import prodtree
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 6)
    rng = random.Random(SEED + 6)
    rows, sweep = [], []
    for what, R, n, T, even in TREE_SHAPES:
        ms = [rng.getrandbits(4096) | (1 << 4095) | 1 for _ in range(T)]
        if even:
            ms[-1] -= 1
        per_row = [ms[r * T // R] for r in range(R)]
        if T > 1:
            rm = ops.rows_modulus(per_row, 512, dev)
            table, midx, moduli = rm.table, rm.midx, rm.moduli
            old = functools.partial(mulmod_tree, ops, rm=rm)
        else:
            table = ops._rows_table(tuple(ms), 512, str(dev))
            midx, moduli = None, tuple(ms)
            old = functools.partial(mulmod_tree, ops,
                                    pack=ops.pack_modulus(ms[0]))
        L16 = table.L16
        x = torch.randint(0, 1 << 16, (R, n, L16), generator=gen, device=dev,
                          dtype=torch.int32)
        corr = ops._tree_correction(moduli, table.L32, n, str(dev))
        bodies = geometry.TREE_BODIES[1:] if even else geometry.TREE_BODIES

        def launch(body, **geom):
            impl = body[len("prod_rows["):-1]
            return functools.partial(
                prodtree.prod_rows_cuda, x, table, midx, impl,
                corr if impl == "montgomery" else None, **geom)

        reps = 2 if R > 1000 else 5
        times, results = defaultdict(list), {}
        for body in ("old",) + bodies + bodies[::-1] + ("old",):
            fn = (lambda: old(x)) if body == "old" else launch(body)
            t, results[body] = time_ms(fn, reps)
            times[body].append(t)
        sel = _sample(R)
        xs = bi.to_ints(x[torch.as_tensor(sel, device=dev)].cpu())
        want = []
        for i, r in enumerate(sel):
            p = 1
            for v in xs[i * n:(i + 1) * n]:
                p = p * v % per_row[r]
            want.append(p)
        levels = tree_levels(n)
        for body in bodies:
            impl = body[len("prod_rows["):-1]
            got = results[body]
            assert torch.equal(got, results["old"]), \
                f"{body} {what}: differs from the tree of mulmods"
            smp = _tree_sample(x, table, midx,
                               corr if impl == "montgomery" else None, got,
                               sel, impl, device=dev)
            plain_ms, plain = once_ms(lambda: _tree_plain(smp))
            err = compare(bi, f"{body} {what}", smp["out"], plain, want)
            g = geometry.tree_geometry(body, R, n, table.L32)
            inst = tree_instantiation(body, g)
            regs = ptxas.get(inst, {})
            check_spills(inst, regs)
            bnd, by = bound_ms(word_products("prod_rows", 128, factors=n), R,
                               R * (n + 1) * L16 * 4)
            row = dict(body=body, what=what, B=R, k=128, factors=n, moduli=T,
                       ms=float(np.mean(times[body])), turns_ms=times[body],
                       old_tree_ms=float(np.mean(times["old"])),
                       old_turns_ms=times["old"], old_launches=len(levels),
                       bound_ms=bnd, bound_by=by,
                       plain_ms=plain_ms, plain_rows=len(sel),
                       max_abs_err=err, library_ms=None, tpi=g.tpi,
                       groups=g.groups, threads=g.threads,
                       instantiation=inst, **regs)
            rows.append(row)
            log(f"  {body} {what}: {R} rows of {n} factors at k=128 over {T}"
                f" moduli ({inst}, G={g.groups}, {g.threads} threads: "
                f"{regs.get('registers')} registers, "
                f"{regs.get('spill_stores')} B spills): {row['ms']:.4f} ms "
                f"(turns " + ", ".join(f"{t:.4f}" for t in times[body])
                + f"), bound {bnd:.4f} ms; the tree of {len(levels)} mulmod "
                f"launches {row['old_tree_ms']:.4f} ms (turns " + ", ".join(
                    f"{t:.4f}" for t in times["old"])
                + f"); plain {plain_ms:.1f} ms on {len(sel)} rows (card); "
                f"equal to the old tree on every row, to the plain version "
                f"and Python ints on {len(sel)}")
        for body in (() if even else bodies):
            default = results[body]
            best = None
            for tpi in TREE_SWEEP_TPI:
                for G in TREE_SWEEP_GROUPS:
                    cap = geometry.TREE_MAX_THREADS[tpi]
                    if tpi * G > cap:
                        continue
                    for threads in sorted({max(tpi * G, 64),
                                           min(cap, max(tpi * G, 128))}):
                        g = geometry.tree_geometry(body, R, n, 128, tpi, G,
                                                   threads)
                        t, got = time_ms(launch(body, tpi=tpi, groups=G,
                                                threads=threads), reps)
                        assert torch.equal(got, default), (body, what, tpi,
                                                           G, threads)
                        inst = tree_instantiation(body, g)
                        regs = ptxas.get(inst, {})
                        check_spills(inst, regs)
                        smem_int, regs_int = resident_integers(
                            g, regs.get("registers", 0))
                        bnd = bound_ms(word_products(
                            "prod_rows", 128, factors=n), R,
                            R * (n + 1) * L16 * 4)[0]
                        row = dict(body=body, what=what, B=R, tpi=tpi,
                                   groups=G, threads=threads, ms=t,
                                   bound_ms=bnd,
                                   registers=regs.get("registers"),
                                   resident_groups_by_smem=smem_int,
                                   resident_groups_by_regs=regs_int,
                                   default=g == geometry.tree_geometry(
                                       body, R, n, 128))
                        sweep.append(row)
                        if best is None or t < best["ms"]:
                            best = row
            log(f"  sweep {body} {what}: fastest TPI {best['tpi']}, G "
                f"{best['groups']}, {best['threads']} threads: "
                f"{best['ms']:.4f} ms; default "
                f"{float(np.mean(times[body])):.4f} ms; TPI/G/threads ms: "
                + ", ".join(
                    f"{r['tpi']}/{r['groups']}/{r['threads']} {r['ms']:.3f}"
                    for r in sweep if r["body"] == body and r["what"] == what))
        del results, x
        torch.cuda.empty_cache()
    return rows, sweep


class LaunchRecorder:
    """While installed, wraps the six kernel wrappers: CUDA events around
    every launch, keyed by (body, B, k); the first launch of each
    per-row-modulus shape (body, B, k, exponent limbs; the product tree's
    (body, rows, k, factors a row)) keeps sample rows of its operands, its
    rows' moduli and its result on the card.
    :meth:`device_ms` sums the launches' event times; :meth:`check_rows`
    holds every sample against the plain version (on the card, one call
    per body and exponent width: the 2,048-bit ladders of the plain
    version take minutes on the host) and returns one row per shape."""

    def __init__(self, mx, lm, geometry):
        self.mx, self.lm, self.geometry = mx, lm, geometry
        self.events = defaultdict(list)
        self.samples = {}
        self._real = {}

    def _timed(self, shape, fn):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        stop.record()
        self.events[shape].append((start, stop))
        return out

    def _sample_rows(self, key, rm, **tensors):
        sel = torch.as_tensor(_sample(key[1]), device=rm.midx.device)
        self.samples[key] = dict(
            {name: x[sel].clone() for name, x in tensors.items()},
            dm=replace(rm, midx=rm.midx[sel]).per_row(),
            moduli=len(rm.moduli))

    def __enter__(self):
        from repro_torch.kernels import prodtree
        mx, lm, geometry = self.mx, self.lm, self.geometry
        real = self._real = {
            (lm, "mulmod_cuda"): lm.mulmod_cuda,
            (lm, "mulmod_rows_cuda"): lm.mulmod_rows_cuda,
            (mx, "modexp_cuda"): mx.modexp_cuda,
            (mx, "modexp_rows_cuda"): mx.modexp_rows_cuda,
            (mx, "_launch_fixed"): mx._launch_fixed,
            (prodtree, "prod_rows_cuda"): prodtree.prod_rows_cuda}

        def mulmod_cuda(a, b, dm, tpi=None):
            return self._timed(("mulmod", int(a.shape[0]), dm.L32),
                               lambda: real[(lm, "mulmod_cuda")](a, b, dm,
                                                                 tpi))

        def modexp_cuda(base, exp, dm, method, reduce_impl, tpi=None):
            body = geometry.body_name("modexp", reduce_impl, method)
            return self._timed((body, int(base.shape[0]), dm.L32),
                               lambda: real[(mx, "modexp_cuda")](
                                   base, exp, dm, method, reduce_impl, tpi))

        def launch_fixed(base, B0, windows, dms, mont, tpi):
            body = geometry.body_name("modexp_fixed",
                                      "montgomery" if mont else "barrett")
            return self._timed((body, int(base.shape[0]), dms[0].L32),
                               lambda: real[(mx, "_launch_fixed")](
                                   base, B0, windows, dms, mont, tpi))

        def mulmod_rows_cuda(a, b, rm, reduce_impl=None, tpi=None,
                             threads=None):
            body = geometry.body_name("mulmod_rows",
                                      lm.rows_reduction(rm, reduce_impl))
            shape = (body, int(a.shape[0]), rm.table.L32)
            out = self._timed(shape, lambda: real[(lm, "mulmod_rows_cuda")](
                a, b, rm, reduce_impl, tpi, threads))
            key = shape + (0,)
            if key not in self.samples and shape[1]:
                self._sample_rows(key, rm, a=a, b=b, out=out)
            return out

        def modexp_rows_cuda(base, exp, rm, method, reduce_impl, tpi=None,
                             threads=None):
            body = geometry.body_name("modexp_rows", reduce_impl, method)
            shape = (body, int(base.shape[0]), rm.table.L32)
            out = self._timed(shape, lambda: real[(mx, "modexp_rows_cuda")](
                base, exp, rm, method, reduce_impl, tpi, threads))
            key = shape + (int(exp.shape[1]),)
            if key not in self.samples and shape[1]:
                self._sample_rows(key, rm, base=base, exp=exp, out=out)
            return out

        def prod_rows_cuda(x, table, midx, reduce_impl, corr=None, tpi=None,
                           groups=None, threads=None):
            body = geometry.body_name("prod_rows", reduce_impl)
            shape = (body, int(x.shape[0]), table.L32)
            out = self._timed(shape, lambda: real[(prodtree,
                                                   "prod_rows_cuda")](
                x, table, midx, reduce_impl, corr, tpi, groups, threads))
            key = shape + (int(x.shape[1]),)
            if key not in self.samples and shape[1]:
                self.samples[key] = dict(
                    _tree_sample(x, table, midx, corr, out, _sample(shape[1]),
                                 reduce_impl, device=x.device),
                    moduli=int(table.mw.shape[0]))
            return out

        for (mod, attr), fn in (((lm, "mulmod_cuda"), mulmod_cuda),
                                ((lm, "mulmod_rows_cuda"), mulmod_rows_cuda),
                                ((mx, "modexp_cuda"), modexp_cuda),
                                ((mx, "modexp_rows_cuda"), modexp_rows_cuda),
                                ((mx, "_launch_fixed"), launch_fixed),
                                ((prodtree, "prod_rows_cuda"),
                                 prod_rows_cuda)):
            setattr(mod, attr, fn)
        return self

    def __exit__(self, *exc):
        for (mod, attr), fn in self._real.items():
            setattr(mod, attr, fn)
        return False

    def device_ms(self):
        """Summed event milliseconds of every recorded launch, then
        cleared (the events of one run)."""
        torch.cuda.synchronize()
        total = sum(a.elapsed_time(b) for evs in self.events.values()
                    for a, b in evs)
        self.events.clear()
        return total

    def shape_ms(self):
        """{(body, B, k): (launches, median ms)} of the events so far."""
        torch.cuda.synchronize()
        return {shape: (len(evs), float(np.median(
            [a.elapsed_time(b) for a, b in evs])))
            for shape, evs in self.events.items()}

    def check_rows(self, timed):
        """Every sampled rows shape against the plain version on the card;
        ``timed`` is :meth:`shape_ms` of the run that launched them."""
        lm, mx = self.lm, self.mx
        groups = defaultdict(list)
        for key in sorted(self.samples):
            body, _, k, le16 = key
            groups[(body, k, le16)].append(key)
        want, secs = {}, []
        for (body, k, le16), keys in groups.items():
            s = [self.samples[k] for k in keys]
            dm = cat_moduli([x["dm"] for x in s])
            t0 = time.perf_counter()
            if body.startswith("prod_rows"):     # le16: factors a row
                out = _tree_plain(dict(
                    s[0], x=torch.cat([x["x"] for x in s]), dm=dm,
                    corr=None if s[0]["corr"] is None
                    else torch.cat([x["corr"] for x in s])))
            elif body.startswith("mulmod_rows"):
                plain = lm.mulmod_mont_plain \
                    if body == "mulmod_rows[montgomery]" else lm.mulmod_plain
                out = plain(torch.cat([x["a"] for x in s]),
                            torch.cat([x["b"] for x in s]), dm)
            else:
                impl, method = rows_body(body)
                out = mx.modexp_plain(torch.cat([x["base"] for x in s]),
                                      torch.cat([x["exp"] for x in s]), dm,
                                      method, impl)
            torch.cuda.synchronize()
            secs.append((body, k, 0 if body.startswith("prod_rows")
                         else 16 * le16, time.perf_counter() - t0))
            i = 0
            for k, x in zip(keys, s):
                n = x["out"].shape[0]
                want[k] = out[i:i + n]
                i += n
        log("  plain versions of the sampled rows on the card: " + ", ".join(
            f"{body} k={k}" + (f" {bits}-bit exps" if bits else "")
            + f" {t:.1f} s" for body, k, bits, t in secs))
        rows = []
        for key in sorted(self.samples):
            body, B, k, le16 = key
            got = self.samples[key]["out"]
            err = int((got.long() - want[key].long()).abs().max())
            assert err == 0, f"{key}: kernel differs from its plain " \
                f"version on sample rows (max abs limb error {err})"
            L16 = int(got.shape[1])
            if body.startswith("prod_rows"):
                s = self.samples[key]
                work = word_products("prod_rows", k, factors=le16)
                moved = B * (le16 + 1) * L16 * 4
            elif body.startswith("mulmod_rows"):
                work, moved = word_products("mulmod", k), B * 3 * L16 * 4
            else:
                impl, method = rows_body(body)
                work = word_products("modexp", k, exp_bits=16 * le16,
                                     mont=impl == "montgomery",
                                     win4=method == "win4")
                moved = B * (2 * L16 + le16) * 4
            n, ms = timed[(body, B, k)]
            bnd, by = bound_ms(work, B, moved + B * 4)
            tree = body.startswith("prod_rows")
            rows.append(dict(body=body, B=B, k=k,
                             exp_bits=0 if tree else 16 * le16,
                             **({"factors": le16} if tree else {}),
                             moduli=self.samples[key]["moduli"],
                             launches=n, ms=ms, bound_ms=bnd, bound_by=by,
                             sample_rows=int(got.shape[0]),
                             max_abs_err=err))
        return rows


def serve_config(protocol, QuantSpec, cipher, seed, key_bits=None,
                 iters=SERVE_ITERS):
    """The main path's LASSO config for one tenant (its seed and key)."""
    return replace(lasso_config(protocol, QuantSpec, cipher, iters),
                   seed=seed, key_bits=key_bits or KEY_BITS)


def solo_run(runner, inst, cfg):
    """A tenant's solo reference on the card: ``run_on_runtime``'s
    build/collect split, keeping the runtime for its rng state."""
    rt, master, wl, mode = runner.build_runtime(inst.A, inst.y, cfg)
    master.start()
    rt.sched.run()
    assert master.done
    return runner.collect_result(rt, master, wl, mode), rt


def check_tenants(path, eng, results, solos, report_core, diff_reports):
    """Every tenant equals its solo run: report core (``diff_reports``
    clean), history bytes and the blinding rng's post-run state."""
    for tid, (solo, solo_rt) in solos.items():
        got = results[tid]
        diff = diff_reports(got.stats, solo.stats)
        assert not diff and report_core(got.stats) == \
            report_core(solo.stats), f"{path} {tid}: {diff}"
        assert got.history.tobytes() == solo.history.tobytes(), \
            f"{path} {tid}: history differs from its solo run"
        box = eng.tenants[tid].rt.box
        assert box.rng.getstate() == solo_rt.box.rng.getstate(), \
            f"{path} {tid}: rng state differs from its solo run"


def run_serve_s1(runner, protocol, QuantSpec, make_lasso, report_core,
                 diff_reports, build, ProtocolEngine, recorder,
                 plain_history):
    """S1: four gold-batched LASSO tenants (seeds 0-3) at the main path's
    key and cut, SERVE_ITERS rounds each, in one concurrent engine; each
    against its solo ``run_on_runtime`` on the card."""
    inst = make_lasso(M, N, sparsity=0.1, noise=0.01, seed=SEED)
    solos, solo_wall = {}, 0.0
    recorder.device_ms()
    for s in SERVE_SEEDS:
        t0 = time.perf_counter()
        solos[f"t{s}"] = solo_run(runner, inst, serve_config(
            protocol, QuantSpec, "gold", s))
        torch.cuda.synchronize()
        solo_wall += time.perf_counter() - t0
    solo_device = recorder.device_ms()
    solo_launches = sum(res.stats["runtime"]["launches"]
                        for res, _ in solos.values())
    build.reset_launches()
    t0 = time.perf_counter()
    eng = ProtocolEngine(admission="concurrent")
    for s in SERVE_SEEDS:
        eng.admit(inst.A, inst.y, serve_config(protocol, QuantSpec, "gold",
                                               s), tid=f"t{s}")
    t_admit = time.perf_counter() - t0
    results = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, shapes = dict(build.LAUNCHES), dict(build.SHAPE_LAUNCHES)
    timed = recorder.shape_ms()
    each = {f"{body} B={B} k={k}": [round(a.elapsed_time(b), 4)
                                    for a, b in evs]
            for (body, B, k), evs in sorted(recorder.events.items())
            if "rows" in body}
    fused_device = recorder.device_ms()
    log("  S1 rows launches, CUDA-event ms of each (the wrapper's host "
        "time included where the device waited for it): " + json.dumps(each))
    check_tenants("S1", eng, results, solos, report_core, diff_reports)
    for tid, res in results.items():
        assert res.history.tobytes() == \
            plain_history[:SERVE_ITERS].tobytes(), \
            f"S1 {tid}: history differs from the plain chain"
    serve = eng.stats()["serve"]
    assert serve["fused_launches"] > 0, serve
    assert serve["launches"] < solo_launches, (serve["launches"],
                                               solo_launches)
    check_launches("serving path (S1)", launches, SERVE_BODIES,
                   absent=BARRETT_ROWS_BODIES)
    rounds = {tid: res.stats["runtime"]["iter_times"]
              for tid, res in results.items()}
    # every tenant's phase clock laps at its own round ends, device
    # synchronized; the tenants move in step, so t0's is the fused round
    fused_rounds = results["t0"].stats["seconds"]["rounds"]
    solo_rounds = {tid: solo.stats["seconds"]["rounds"]
                   for tid, (solo, _) in solos.items()}
    log(f"  S1: wall {wall:.2f} s (admission, keygen included, "
        f"{t_admit:.2f} s), virtual time {serve['virtual_time']:.4f} s; "
        f"round completion times (virtual) " + json.dumps(rounds))
    log("  S1 rounds (wall s): fused " + ", ".join(
        f"{t:.4f}" for t in fused_rounds) + "; solo " + json.dumps(
        {tid: [round(t, 4) for t in r] for tid, r in solo_rounds.items()}))
    log("  S1 serve: " + json.dumps(
        {k: serve[k] for k in ("launches", "rows_launches", "fused_launches",
                               "fused_ops")}) + f"; solo launches "
        f"{solo_launches}")
    log(f"  S1 kernel device ms: fused {fused_device:.1f} ms in "
        f"{wall:.2f} s wall; the 4 solo runs {solo_device:.1f} ms in "
        f"{solo_wall:.2f} s wall")
    log(f"  S1 launches {launches}; rows bodies by shape " + json.dumps(
        [{"body": body, "B": B, "k": k, "launches": n}
         for (body, B, k), n in sorted(shapes.items()) if "rows" in body]))
    log(f"  S1: every tenant's history, report core and rng state equal "
        f"its solo run; every history equals the plain chain")
    summary = dict(wall_s=wall, admit_s=t_admit,
                   virtual_s=serve["virtual_time"],
                   fused_rounds_s=fused_rounds, solo_rounds_s=solo_rounds,
                   fused_device_ms=fused_device, solo_device_ms=solo_device,
                   solo_wall_s=solo_wall, solo_launches=solo_launches,
                   **{k: serve[k] for k in ("launches", "rows_launches",
                                            "fused_launches", "fused_ops")})
    return summary, solos, launches, shapes, timed


def run_serve_s2(runner, protocol, QuantSpec, make_lasso, report_core,
                 diff_reports, build, ProtocolEngine, recorder, solos):
    """S2: mixed widths and arms — two 2,048-bit gold tenants (S1's seeds
    0 and 1, the second admitted STAGGER_S virtual seconds late; their
    solo runs are S1's), two SERVE_SMALL_BITS gold tenants (the second
    cancelled after one round) and a vec tenant of that width, which runs
    solo groups.
    No launch mixes limb widths; every tenant equals its solo run."""
    inst = make_lasso(M, N, sparsity=0.1, noise=0.01, seed=SEED)
    plan = [("a", "gold", 0, KEY_BITS, 0.0, None),
            ("b", "gold", 1, KEY_BITS, STAGGER_S, None),
            ("c", "gold", 2, SERVE_SMALL_BITS, 0.0, None),
            ("d", "gold", 3, SERVE_SMALL_BITS, 0.0, 1),
            ("e", "vec", 4, SERVE_SMALL_BITS, 0.0, None)]
    refs = {"a": solos["t0"], "b": solos["t1"]}
    for tid, cipher, seed, bits, _, cancel in plan[2:]:
        refs[tid] = solo_run(runner, inst, serve_config(
            protocol, QuantSpec, cipher, seed, key_bits=bits,
            iters=cancel or SERVE_ITERS))
    recorder.device_ms()
    build.reset_launches()
    t0 = time.perf_counter()
    eng = ProtocolEngine(admission="concurrent")
    for tid, cipher, seed, bits, at, cancel in plan:
        eng.admit(inst.A, inst.y, serve_config(protocol, QuantSpec, cipher,
                                               seed, key_bits=bits),
                  tid=tid, admit_at=at, cancel_after=cancel)
    results = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, shapes = dict(build.LAUNCHES), dict(build.SHAPE_LAUNCHES)
    timed = recorder.shape_ms()
    device = recorder.device_ms()
    check_tenants("S2", eng, results, refs, report_core, diff_reports)
    width = {tid: (eng.tenants[tid].rt.key.n2.bit_length() + 7) // 8
             for tid, *_ in plan}
    for entry in eng.collector.fused_log:
        assert {width[t] for t in entry["tenants"]} == \
            {entry["limb_bytes"]}, f"S2 launch mixes widths: {entry}"
        assert "e" not in entry["tenants"], entry
    serve = eng.stats()["serve"]
    per = serve["per_tenant"]
    assert per["d"]["cancelled"] and per["d"]["rounds"] == 1, per["d"]
    assert per["b"]["started_at"] >= STAGGER_S, per["b"]
    assert serve["fused_launches"] > 0, serve
    check_launches("serving path (S2)", launches, SERVE_BODIES,
                   absent=BARRETT_ROWS_BODIES)
    widths = sorted({e["limb_bytes"] for e in eng.collector.fused_log})
    log(f"  S2: wall {wall:.2f} s, virtual {serve['virtual_time']:.4f} s, "
        f"kernel device ms {device:.1f}; serve " + json.dumps(
            {k: serve[k] for k in ("launches", "rows_launches",
                                   "fused_launches", "fused_ops")})
        + f"; fused widths (bytes of n^2) {widths}, never mixed; tenant d "
        f"cancelled after 1 round, b started at {per['b']['started_at']} s; "
        f"every tenant equals its solo run")
    log(f"  S2 launches {launches}")
    return dict(wall_s=wall, virtual_s=serve["virtual_time"],
                device_ms=device, fused_widths=widths,
                **{k: serve[k] for k in ("launches", "rows_launches",
                                         "fused_launches", "fused_ops")}), \
        launches, shapes, timed


def run_sync_s4(pb, bi, gold, keys):
    """S4: S1's fused rows ops over its tenants' ``keys`` at S1's shapes
    (a round's 2 K Nk encryptions a tenant, their sums, the K Nk x Nk
    matvec blocks, the decryptions of K Nk) under
    ``torch.cuda.set_sync_debug_mode("error")`` until the first read-back
    of a result (``bigint.to_ints`` in ``dec_rows``), which may wait: any
    earlier wait for the device raises (first shown to raise on a read of
    a device tensor and on a blocking upload).  Then every result is
    decrypted and held against Python ints.  Returns a summary."""
    rng = random.Random(SEED + 9)
    n_enc, T = 2 * K * NK, len(keys)
    enc_items = [(k, [rng.getrandbits(32) for _ in range(n_enc)],
                  [gold.rand_r(k, rng) for _ in range(n_enc)]) for k in keys]
    Ks = [np.array([[[rng.getrandbits(16) for _ in range(NK)]
                     for _ in range(NK)] for _ in range(K)], dtype=object)
          for _ in keys]
    dev = torch.device(DEVICE)

    def fused():
        cts = pb.enc_rows(enc_items, device=dev)
        sums = pb.add_rows([(k, c, c) for k, c in zip(keys, cts)],
                           device=dev)
        mv = pb.matvec_rows([(k, Kb, [c[e * NK:(e + 1) * NK]
                                      for e in range(K)])
                             for k, Kb, c in zip(keys, Ks, cts)],
                            device=dev)
        dec = pb.dec_rows([(k, c[:K * NK]) for k, c in zip(keys, cts)],
                          device=dev)
        return cts, sums, mv, dec

    fused()                           # tables and kernels built, warm
    torch.cuda.synchronize()
    # the detector sees what the launch path used to do: a read of a
    # device index and a blocking upload
    caught = []
    torch.cuda.set_sync_debug_mode("error")
    try:
        for probe in (lambda: int(torch.arange(3, device=dev).max()),
                      lambda: torch.as_tensor(np.arange(3), device=dev)):
            try:
                probe()
            except RuntimeError:
                caught.append(True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert caught == [True, True], "S4: the sync detector missed a probe"
    real_to_ints, reads = pb.bi.to_ints, []

    def to_ints(x):                   # the first read-back may wait
        reads.append(torch.cuda.get_sync_debug_mode())
        torch.cuda.set_sync_debug_mode(0)
        return real_to_ints(x)

    t0 = time.perf_counter()
    pb.bi.to_ints = to_ints
    torch.cuda.set_sync_debug_mode("error")
    try:
        cts, sums, mv, dec = fused()
    finally:
        torch.cuda.set_sync_debug_mode(0)
        pb.bi.to_ints = real_to_ints
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    assert reads and reads[0] == 2, reads
    assert dec == [ms[:K * NK] for _, ms, _ in enc_items], \
        "S4: decryption differs from the plaintexts"
    back = pb.dec_rows([(k, s) for k, s in zip(keys, sums)], device=dev)
    assert back == [[2 * m % k.n for m in ms] for k, ms, _ in enc_items], \
        "S4: the sums decrypt wrong"
    back = pb.dec_rows([(k, o.reshape(-1, o.shape[-1]))
                        for k, o in zip(keys, mv)], device=dev)
    for (k, ms, _), Kb, got in zip(enc_items, Ks, back):
        want = [sum(int(Kb[e, i, j]) * ms[e * NK + j] for j in range(NK))
                % k.n for e in range(K) for i in range(NK)]
        assert got == want, "S4: the matvec decrypts wrong"
    out = dict(wall_s=wall, tenants=T, enc_rows=T * n_enc,
               matvec_rows=T * K * NK * NK, dec_rows=T * K * NK,
               read_backs=len(reads))
    log("  S4: enc_rows, add_rows, matvec_rows and dec_rows of S1's shapes "
        "ran under set_sync_debug_mode('error') up to dec_rows' read-back; "
        "every result decrypts to Python ints: " + json.dumps(out))
    return out


def run_cli(args, timeout, ok_codes=(0,)):
    """``python -m <args>`` from the repository root; returns its exit
    code, stdout and wall seconds (raises on another exit code)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", *args], capture_output=True,
                          text=True, timeout=timeout, env=env, cwd=REPO)
    secs = time.perf_counter() - t0
    assert proc.returncode in ok_codes, \
        f"{args[0]} exited {proc.returncode}:\n{proc.stderr[-4000:]}"
    return proc.returncode, proc.stdout, secs


def run_serve_clis(calib):
    """S3: ``serve_sim`` at the main path's key and cut with 8 tenants and
    a trace; ``serve_sim --admission auto --tune`` at a smaller cut into
    the calibration cache ``calib``; ``obs.report --json`` on the trace;
    ``obs.sentinel --json`` on this run's ledger (exit 2 or a correctness
    finding fails)."""
    trace = os.path.join(REPO, "build", "serve.trace.json")
    _, out, secs = run_cli(
        ["repro_torch.launch.serve_sim", "--tenants", "8", "--key-bits",
         str(KEY_BITS), "--edges", str(K), "--block", str(NK), "--iters",
         str(SERVE_ITERS), "--trace", trace], 900)
    sim = json.loads(out)
    assert sim["fused_launches"] > 0 and sim["tenants"] == 8, sim
    assert all(p["rounds"] == SERVE_ITERS for p in sim["per_tenant"].values())
    assert sim["device"] == "torch-cuda-" + \
        torch.cuda.get_device_name(0).replace("/", "-"), sim["device"]
    log(f"  serve_sim --tenants 8: exit 0 in {secs:.1f} s; " + json.dumps(
        {k: v for k, v in sim.items() if k != "per_tenant"},
        separators=(",", ":")))
    if os.path.exists(calib):
        os.remove(calib)
    _, out, tune_s = run_cli(
        ["repro_torch.launch.serve_sim", "--tenants", "4", "--key-bits",
         "1024", "--edges", str(K), "--block", "64", "--iters", "1",
         "--admission", "auto", "--tune", "--tune-widths", "1,2,4,8",
         "--calib-cache", calib], 900)
    tuned_doc, _, auto_doc = out.partition("\n}\n")
    tuned = json.loads(tuned_doc + "\n}")["tuned"]
    auto = json.loads(auto_doc)
    assert auto["window"] == tuned["window"] and \
        not auto["auto_fallback_sequential"], (tuned, auto)
    log(f"  serve_sim --admission auto --tune: exit 0 in {tune_s:.1f} s; "
        f"tuned {json.dumps(tuned)}; auto run window {auto['window']}, "
        f"{auto['launches']} launches, {auto['fused_launches']} fused")
    _, out, _ = run_cli(["repro_torch.obs.report", trace, "--json"], 300)
    rep = json.loads(out)
    assert rep["kind"] == "summary" and rep["spans"] > 0 and rep["core"]
    log(f"  obs.report --json: exit 0, {rep['spans']} spans, core sections "
        f"{sorted(rep['core'])}")
    rc, out, _ = run_cli(["repro_torch.obs.sentinel", "--json", "--ledger",
                          os.environ["REPRO_LEDGER"]], 300, ok_codes=(0, 1))
    sent = json.loads(out)
    drift = [f for f in sent["findings"] if f["check"] == "correctness"]
    assert not drift, f"sentinel: correctness drift {drift}"
    log(f"  obs.sentinel --json: exit {rc}, {sent['records']} records, "
        f"baseline n={sent['baseline_n']}, findings " + json.dumps(
            [f["message"] for f in sent["findings"]]))
    return dict(serve_sim_s=secs, tune_s=tune_s, tuned=tuned,
                sentinel_rc=rc, sentinel_findings=len(sent["findings"]),
                serve_sim=sim)


# ---------------------------------------------------------------------------
# the LM serving stack: the five model families' prefill and decode, the
# greedy Engine and launch.serve (plain PyTorch; no Pallas, so no kernel)
# ---------------------------------------------------------------------------

#: L2's archs at full width and depth (float32 parameters 0.85-14.2 GB)
#: and those at full width with the depth cut to LM_CUT_LAYERS
LM_FULL_DEPTH = ("xlstm_125m", "seamless_m4t_medium", "recurrentgemma_2b")
LM_CUT_DEPTH = ("codeqwen15_7b", "granite_34b", "command_r_35b",
                "llama4_scout_17b_a16e", "qwen2_moe_a27b", "llava_next_34b")
LM_CUT_LAYERS = 2
LM_BATCH, LM_PROMPT, LM_NEW, LM_NEW_L2 = 4, 16, 32, 16
LM_LONG = 2048                  # L1's flash-path prefill, batch 1
#: the reference's own bounds: bf16 prefill/decode against forward
#: (tests/test_models.py:84,92) and the int8 cache against bf16 (:184)
PARITY_BOUND, INT8_BOUND = 0.15, 0.25
#: L3: the card's float32 logits against the CPU's
CARD_CPU_BOUND = 1e-3
#: H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet)
BF16_PER_S = 989e12


def lm_inputs(cfg, B, S, seed=0):
    """Prompts (and the enc-dec family's frames), as launch.serve makes
    them."""
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, cfg.vocab, (B, S), dtype=np.int32)
    frames = (rng.normal(0, 0.02, (B, 8, cfg.d_model)).astype(np.float32)
              if cfg.family == "encdec" else None)
    return prompts, frames


def lm_gap(a, b):
    """max |a - b|; fails on a NaN in either."""
    a, b = a.float(), b.float()
    assert not torch.isnan(a).any() and not torch.isnan(b).any(), "NaN"
    return float((a - b).abs().max())


def lm_gaps(m, cfg, params, prompts, frames, dev):
    """The reference's parity check on the card: prefill's last logits and
    one decode step against ``forward`` on the same and the extended
    tokens; returns the two max gaps."""
    kw = {} if frames is None else {
        "frames": torch.as_tensor(frames, device=dev)}
    tokens = torch.as_tensor(prompts, device=dev).long()
    B, S = tokens.shape
    with torch.inference_mode():
        full = m.forward(params, tokens, cfg, **kw)
        cache = m.init_cache(cfg, B, S + 4, device=dev)
        lg, cache = m.prefill(params, tokens, cfg, cache, **kw)
        nxt = full[:, -1].argmax(-1)
        lg2, _ = m.decode_step(params, nxt, cache, cfg)
        full2 = m.forward(params, torch.cat([tokens, nxt[:, None]], 1),
                          cfg, **kw)
        return (lm_gap(lg.reshape(B, -1), full[:, -1]),
                lm_gap(lg2, full2[:, -1]))


def lm_parity(m, cfg, params, prompts, frames, dev):
    pre, dec = lm_gaps(m, cfg, params, prompts, frames, dev)
    assert pre < PARITY_BOUND and dec < PARITY_BOUND, \
        f"{cfg.name} ({cfg.dtype}): prefill gap {pre}, decode gap {dec}"
    return pre, dec


def lm_time_steps(m, cfg, params, prompts, frames, dev, steps):
    """Wall time of one prefill of ``prompts`` and the mean of ``steps``
    decode steps after it (the Engine's path; device synchronized around
    each), after a warm-up prefill and step."""
    kw = {} if frames is None else {
        "frames": torch.as_tensor(frames, device=dev)}
    tokens = torch.as_tensor(prompts, device=dev).long()
    B, S = tokens.shape
    with torch.inference_mode():
        for timed in (False, True):
            cache = m.init_cache(cfg, B, S + steps + 1, device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, cache = m.prefill(params, tokens, cfg, cache, **kw)
            torch.cuda.synchronize()
            pre_s = time.perf_counter() - t0
            tok = lg.reshape(B, -1).argmax(-1)
            t0 = time.perf_counter()
            for _ in range(steps if timed else 1):
                lg, cache = m.decode_step(params, tok, cache, cfg)
                tok = lg.argmax(-1)
            torch.cuda.synchronize()
            dec_s = (time.perf_counter() - t0) / (steps if timed else 1)
    return pre_s, dec_s


def lm_graph_decode_ms(m, cfg, params, prompts, dev, reps=10):
    """Device time of one decode step: the step captured in a CUDA graph
    and replayed (its kernels back to back, no host work between them),
    by CUDA events over ``reps`` replays."""
    tokens = torch.as_tensor(prompts, device=dev).long()
    B, S = tokens.shape
    with torch.inference_mode():
        cache = m.init_cache(cfg, B, S + 1, device=dev)
        lg, cache = m.prefill(params, tokens, cfg, cache)
        tok = lg.reshape(B, -1).argmax(-1)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):          # warm-up off the capture
            m.decode_step(params, tok, cache, cfg)
        torch.cuda.current_stream().wait_stream(side)
        cache["len"] = S
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            m.decode_step(params, tok, cache, cfg)
        graph.replay()
        ms, _ = time_ms(graph.replay, reps)
    del graph, cache
    return ms


def lm_free():
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def lm_generate(Engine, cfg, params, prompts, frames, max_new):
    eng = Engine(cfg, params)                    # holds the bf16 copy
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eng.generate(prompts, max_new, frames=frames)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    assert out.shape == (prompts.shape[0], max_new), out.shape
    assert (out >= 0).all() and (out < cfg.padded_vocab).all()
    return out, secs


def run_lm_l1(configs, registry, transformer, Engine, dev):
    """L1: Yi-9B at its full published configuration."""
    cfg = configs.get_config("yi_9b")
    m = registry.get_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = m.init(cfg, SEED, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    f32_gb = n_params * 4 / 1e9
    log(f"  yi_9b: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads, n_kv {cfg.n_kv}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab}: {n_params:,} parameters ({f32_gb:.2f} GB float32; "
        f"analytic count {cfg.param_count():,}), drawn in {init_s:.2f} s")
    prompts, _ = lm_inputs(cfg, LM_BATCH, LM_PROMPT)
    out, gen_s = lm_generate(Engine, cfg, params, prompts, None, LM_NEW)
    held_gb = sum(t.numel() * t.element_size() for mod in params.modules()
                  for t in getattr(mod, "_held", {}).values()) / 1e9
    res = {"params": n_params, "f32_gb": f32_gb, "held_bf16_gb": held_gb,
           "init_s": init_s, "generate_s": gen_s,
           "generate_tok_s": LM_BATCH * LM_NEW / gen_s,
           "sample": out[0].tolist()}
    pre_s, dec_s = lm_time_steps(m, cfg, params, prompts, None, dev, LM_NEW)
    res.update(prefill16_s=pre_s,
               prefill16_tok_s=LM_BATCH * LM_PROMPT / pre_s,
               decode_ms=dec_s * 1e3,
               decode_graph_ms=lm_graph_decode_ms(m, cfg, params, prompts,
                                                  dev))
    res["prefill_gap"], res["decode_gap"] = lm_parity(
        m, cfg, params, prompts, None, dev)
    # the flash path: a 2,048-token prompt at batch 1 (timed after one
    # untimed run), its last logits against forward's
    long_prompt, _ = lm_inputs(cfg, 1, LM_LONG, seed=1)
    tokens = torch.as_tensor(long_prompt, device=dev).long()
    with torch.inference_mode():
        for _ in range(2):
            cache = m.init_cache(cfg, 1, LM_LONG, device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, cache = m.prefill(params, tokens, cfg, cache)
            torch.cuda.synchronize()
            long_s = time.perf_counter() - t0
        full = m.forward(params, tokens, cfg)
        res["prefill2048_gap"] = lm_gap(lg.reshape(1, -1), full[:, -1])
        del full, cache
    assert res["prefill2048_gap"] < PARITY_BOUND, res["prefill2048_gap"]
    res.update(prefill2048_s=long_s, prefill2048_tok_s=LM_LONG / long_s)
    # the int8 cache: token-by-token decode of a 12-token prompt, then one
    # step against the bf16 cache's (the reference's test_models.py:169)
    toks = torch.as_tensor(lm_inputs(cfg, LM_BATCH, 12, seed=2)[0],
                           device=dev).long()
    with torch.inference_mode():
        cache = m.init_cache(cfg, LM_BATCH, 18, device=dev)
        lg, cache = m.prefill(params, toks, cfg, cache)
        nxt = lg.reshape(LM_BATCH, -1).argmax(-1)
        lg_bf16, _ = m.decode_step(params, nxt, cache, cfg)
        qc = transformer.init_cache(cfg, LM_BATCH, 18, quantized=True,
                                    device=dev)
        for i in range(12):
            _, qc = m.decode_step(params, toks[:, i], qc, cfg)
        lg_q, _ = m.decode_step(params, nxt, qc, cfg)
        res["int8_gap"] = lm_gap(lg_q, lg_bf16)
    assert res["int8_gap"] < INT8_BOUND, res["int8_gap"]
    res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    # least time: the bf16 weights a step reads (all but the embedding
    # table, of which it reads B rows) over HBM, against its bf16 flops
    body = n_params - cfg.padded_vocab * cfg.d_model
    res["decode_bound_ms"] = max(body * 2 / HBM_BYTES_PER_S,
                                 2 * body * LM_BATCH / BF16_PER_S) * 1e3
    log(f"  yi_9b: generate B={LM_BATCH}, prompt {LM_PROMPT}, {LM_NEW} new: "
        f"{gen_s:.3f} s ({res['generate_tok_s']:.1f} tok/s); prefill "
        f"{LM_BATCH}x{LM_PROMPT}: {pre_s * 1e3:.2f} ms "
        f"({res['prefill16_tok_s']:.1f} tok/s); prefill 1x{LM_LONG} (flash): "
        f"{long_s * 1e3:.1f} ms ({res['prefill2048_tok_s']:.1f} tok/s); "
        f"decode {res['decode_ms']:.2f} ms/step, its kernels "
        f"{res['decode_graph_ms']:.2f} ms replayed as a CUDA graph (bound "
        f"{res['decode_bound_ms']:.2f} ms); peak "
        f"{res['peak_gb']:.2f} GB allocated ({held_gb:.2f} GB of it the "
        f"held bf16 copy)")
    log(f"  yi_9b checks: prefill-forward {res['prefill_gap']:.4f}, "
        f"decode-forward {res['decode_gap']:.4f}, prefill {LM_LONG} "
        f"{res['prefill2048_gap']:.4f} (bound {PARITY_BOUND}); int8-bf16 "
        f"cache {res['int8_gap']:.4f} (bound {INT8_BOUND}); no NaN")
    del params
    lm_free()
    return res


def run_lm_l2(configs, registry, Engine, dev):
    """L2: the other nine archs at full width, each freed before the next."""
    results = {}
    for arch in LM_FULL_DEPTH + LM_CUT_DEPTH:
        cfg = configs.get_config(arch)
        cut = None
        if arch in LM_CUT_DEPTH:
            cut = f"n_layers {cfg.n_layers} -> {LM_CUT_LAYERS}"
            cfg = replace(cfg, n_layers=LM_CUT_LAYERS)
        m = registry.get_model(cfg)
        torch.cuda.reset_peak_memory_stats()
        params = m.init(cfg, SEED, dev)
        n_params = sum(p.numel() for p in params.parameters())
        prompts, frames = lm_inputs(cfg, LM_BATCH, LM_PROMPT)
        out, gen_s = lm_generate(Engine, cfg, params, prompts, frames,
                                 LM_NEW_L2)
        pre_s, dec_s = lm_time_steps(m, cfg, params, prompts, frames, dev,
                                     LM_NEW_L2)
        # the gate runs in float32: at full width bf16 rounding alone
        # moves these archs' logits past the bound (xLSTM: the reference's
        # own prefill and forward differ by 0.39 on the same weights), and
        # an MoE call's capacity drops depend on its token count, so its
        # experts take every assignment there (capacity E / top_k)
        gate_cfg = replace(cfg, dtype="float32")
        if cfg.family == "moe":
            gate_cfg = replace(gate_cfg, capacity_factor=float(
                cfg.experts) / cfg.top_k)
        pre_gap, dec_gap = lm_parity(m, gate_cfg, params, prompts, frames,
                                     dev)
        bf16_gaps = lm_gaps(m, cfg, params, prompts, frames, dev)
        r = {"cut": cut, "params": n_params, "f32_gb": n_params * 4 / 1e9,
             "generate_s": gen_s,
             "generate_tok_s": LM_BATCH * LM_NEW_L2 / gen_s,
             "prefill16_ms": pre_s * 1e3, "decode_ms": dec_s * 1e3,
             "prefill_gap": pre_gap, "decode_gap": dec_gap,
             "bf16_gaps": bf16_gaps,
             "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
             "sample": out[0][:8].tolist()}
        results[arch] = r
        log(f"  {arch}: {cut or 'full depth'}, {n_params:,} parameters "
            f"({r['f32_gb']:.2f} GB f32), peak {r['peak_gb']:.2f} GB; "
            f"generate {gen_s:.3f} s ({r['generate_tok_s']:.1f} tok/s); "
            f"prefill {r['prefill16_ms']:.2f} ms, decode "
            f"{r['decode_ms']:.2f} ms/step; float32 gaps prefill "
            f"{pre_gap:.4f}, decode {dec_gap:.4f} (bound {PARITY_BOUND}); "
            f"bf16 gaps {bf16_gaps[0]:.4f}, {bf16_gaps[1]:.4f}; no NaN")
        del params
        lm_free()
    return results


def run_lm_l3(configs, registry, Engine, dev):
    """L3: each reduced config in float32, the card's generate equal to
    the port's CPU run token for token, prefill and decode logits within
    CARD_CPU_BOUND."""
    assert not torch.backends.cuda.matmul.allow_tf32, \
        "float32 checks need TF32 off for matmuls"
    results = {}
    for arch in configs.ARCHS:
        cfg = replace(configs.get_reduced(arch), dtype="float32")
        m = registry.get_model(cfg)
        cpu = m.init(cfg, SEED, "cpu")
        card = m.init(cfg, SEED, "cpu").to(dev)
        prompts, frames = lm_inputs(cfg, 2, 8)
        want = Engine(cfg, cpu).generate(prompts, 8, frames=frames)
        got = Engine(cfg, card).generate(prompts, 8, frames=frames)
        assert np.array_equal(got, want), (arch, got, want)
        gaps = []
        for params, d in ((cpu, torch.device("cpu")), (card, dev)):
            kw = {} if frames is None else {
                "frames": torch.as_tensor(frames, device=d)}
            with torch.inference_mode():
                cache = m.init_cache(cfg, 2, 9, device=d)
                lg, cache = m.prefill(
                    params, torch.as_tensor(prompts, device=d).long(), cfg,
                    cache, **kw)
                lg2, _ = m.decode_step(
                    params, torch.as_tensor(want[:, 0], device=d).long(),
                    cache, cfg)
            gaps.append((lg.cpu(), lg2.cpu()))
        gap = max(lm_gap(a, b) for a, b in zip(*gaps))
        assert gap < CARD_CPU_BOUND, (arch, gap)
        results[arch] = gap
    log("  card equals CPU token for token; max logit gaps " + json.dumps(
        {a: float(f"{g:.3g}") for a, g in results.items()}))
    return results


def run_lm_l4():
    """L4: ``python -m repro_torch.launch.serve --arch xlstm_125m --batch 4``
    (full configuration) as a subprocess."""
    rc, out, secs = run_cli(["repro_torch.launch.serve", "--arch",
                             "xlstm_125m", "--batch", "4"], 300)
    lines = out.strip().splitlines()
    assert lines[0].startswith("generated (4, 32)"), out
    assert lines[1].startswith("sample:"), out
    log(f"  launch.serve --arch xlstm_125m --batch 4: exit {rc} in "
        f"{secs:.1f} s; {lines[0]}")
    return {"rc": rc, "secs": secs, "line": lines[0]}


def run_lm_phase(dev):
    from repro_torch import configs
    from repro_torch.models import registry, transformer
    from repro_torch.serve.engine import Engine
    t0 = time.perf_counter()
    lm = {}
    log("LM L1: yi_9b at its full configuration, Engine.generate and the "
        "2,048-token flash prefill:")
    lm["l1"] = run_lm_l1(configs, registry, transformer, Engine, dev)
    log(f"LM L2: the other nine archs at full width ({', '.join(LM_CUT_DEPTH)}"
        f" cut to {LM_CUT_LAYERS} layers):")
    lm["l2"] = run_lm_l2(configs, registry, Engine, dev)
    log("LM L3: the ten reduced configs in float32, card against CPU:")
    lm["l3"] = run_lm_l3(configs, registry, Engine, dev)
    log("LM L4: python -m repro_torch.launch.serve:")
    lm["l4"] = run_lm_l4()
    lm["phase_s"] = time.perf_counter() - t0
    log(f"  LM phase: {lm['phase_s']:.1f} s")
    return lm


# ---------------------------------------------------------------------------
# LM training: trainable parameters, AdamW, the train step, the data
# pipeline, checkpoints, launch.train, the compressed DP step and SPMD ADMM
# (plain PyTorch and torch.distributed; no Pallas, so no kernel)
# ---------------------------------------------------------------------------

#: T1: Yi-9B at full width with the depth cut, batch x sequence, steps,
#: peak learning rate (AdamW's first steps are sign steps; at this width
#: a larger rate throws the loss up on the second step:
#: scripts/train_lr_sweep.py)
T1_LAYERS, T1_BATCH, T1_SEQ, T1_STEPS, T1_LR = 8, 4, 1024, 6, 3e-6
#: T2: launch.train on xlstm_125m's full configuration: T2_STEPS steps
#: with a checkpoint every T2_CKPT_EVERY, then --resume from T2_RESUME_AT
T2_STEPS, T2_BATCH, T2_SEQ, T2_CKPT_EVERY, T2_RESUME_AT = 8, 8, 256, 4, 4
#: T2: a resumed step's loss against the uninterrupted run's (the first
#: resumed step is a forward from the same weights: equal to the printed
#: digits; later steps carry the card's atomics' rounding in the
#: embedding's and gather's backward, amplified by AdamW)
T2_RESUME_TOL = 1e-2
#: T3: card against CPU, float32 from the same weights: loss and grad
#: norm relative; each gradient leaf against its max-abs (floored at
#: T3_GRAD_REL of the model's largest gradient element: a leaf of float32
#: noise); after one step each parameter element in units of lr (AdamW's
#: g / (|g| + eps) turns a gradient gap d near eps = 1e-8 into up to
#: lr d / (4 eps): float32 noise in, a fraction of a step out)
T3_LOSS_REL, T3_GRAD_REL, T3_STEP_FRAC, T3_LR = 1e-4, 1e-4, 0.5, 1e-2
#: T4: SPMD ADMM (float64) on the NCCL group against the gloo group's run
T4_ADMM_TOL = 1e-10
#: the H100's float32 rate outside the tensor cores (NVIDIA data sheet)
FP32_PER_S = 67e12


def train_step_bound(cfg, B, S, n_params):
    """Least time of one dense ``make_train_step`` step (remat on) on the
    card, from the code's shapes: its bf16 matmuls (forward, the blocks'
    recomputed forward, backward twice the forward) over 989 TFLOP/s, its
    float32 attention scores and weighted sums (``attention_naive``:
    every (query, key) pair, masked or not) over 67 TFLOP/s, and AdamW's
    28 bytes a parameter (read p, g, m, v; write p, m, v) over HBM.  The
    recomputation stops once it has every tensor the backward saved
    (``torch.utils.checkpoint``'s early stop), so a block's last matmul,
    ``w_down``, is not run again."""
    d, hd, H, KV, ff = cfg.d_model, cfg.hd, cfg.q_heads, cfg.n_kv, cfg.d_ff
    T = B * S
    layer = 2 * T * (d * H * hd + 2 * d * KV * hd + H * hd * d + 3 * d * ff)
    head = 2 * T * d * cfg.padded_vocab
    fwd = cfg.n_layers * layer + head
    recompute = cfg.n_layers * (layer - 2 * T * ff * d)
    mm_flops = fwd + recompute + 2 * fwd
    attn_fwd = cfg.n_layers * 2 * (2 * B * H * S * S * hd)
    attn_flops = 4 * attn_fwd
    adam_bytes = 28 * n_params
    parts = {"bf16_matmul_ms": mm_flops / BF16_PER_S * 1e3,
             "f32_attention_ms": attn_flops / FP32_PER_S * 1e3,
             "adamw_bytes_ms": adam_bytes / HBM_BYTES_PER_S * 1e3}
    return sum(parts.values()), dict(parts, bf16_tflop=mm_flops / 1e12,
                                     f32_tflop=attn_flops / 1e12,
                                     adamw_gb=adam_bytes / 1e9)


def train_pipe(pipeline, registry, cfg, batch, seq):
    """The trainer's pipeline for ``cfg``, as launch.train builds it."""
    return pipeline.TokenPipeline(
        vocab=cfg.vocab, batch=batch, seq=seq, seed=SEED,
        prefix=cfg.n_prefix if cfg.frontend == "vision" else 0,
        enc_len=registry.enc_len(cfg, seq) if cfg.family == "encdec"
        else 0, d_model=cfg.d_model)


def run_train_t1(configs, registry, pipeline, loop, optimizer, dev):
    """T1: Yi-9B at full width, depth cut, bf16 compute on float32 master
    weights, remat, six make_train_step steps on TokenPipeline batches."""
    cfg = replace(configs.get_config("yi_9b"), n_layers=T1_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    state = loop.init_train_state(cfg, SEED, dev)
    n_params = sum(p.numel() for p in state["params"].parameters())
    ocfg = optimizer.OptConfig(lr=T1_LR, warmup_steps=1,
                               total_steps=T1_STEPS)
    step = loop.make_train_step(cfg, ocfg, remat=True)
    pipe = train_pipe(pipeline, registry, cfg, T1_BATCH, T1_SEQ)
    losses, gnorms, secs = [], [], []
    for i in range(T1_STEPS):
        batch = pipe.next(device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, met = step(state, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(met["loss"]))
        gnorms.append(float(met["grad_norm"]))
        if i + 1 == D1_STEPS:              # D1's reference, on the host
            snapshot = [p.detach().to("cpu", copy=True) for p in
                        state["params"].parameters()]
    assert all(np.isfinite(losses)) and all(np.isfinite(gnorms)), losses
    assert losses[-1] < losses[0], f"T1: loss did not fall: {losses}"
    # one more step split by CUDA events: loss and backward, then AdamW
    params = state["params"]
    events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    batch = pipe.next(device=dev)
    events[0].record()
    registry.get_model(cfg).loss_fn(params, batch, cfg, remat=True,
                                    use_scan=True).backward()
    events[1].record()
    optimizer.adamw_update([p.grad for p in params.parameters()],
                           state["opt"], params, ocfg)
    events[2].record()
    torch.cuda.synchronize()
    params.zero_grad(set_to_none=True)
    split = {"loss_backward_ms": events[0].elapsed_time(events[1]),
             "adamw_ms": events[1].elapsed_time(events[2])}
    bound, parts = train_step_bound(cfg, T1_BATCH, T1_SEQ, n_params)
    steady = float(np.median(secs[1:]))
    res = {"layers": cfg.n_layers, "params": n_params,
           "state_gb": n_params * 16 / 1e9, "losses": losses,
           "grad_norms": gnorms, "step_ms": [x * 1e3 for x in secs],
           "median_step_ms": steady * 1e3,
           "tokens_per_s": T1_BATCH * T1_SEQ / steady,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "bound_ms": bound, "bound_parts": parts, "split": split,
           "snapshot": snapshot}
    log(f"  yi_9b, {cfg.n_layers} of 48 layers at full width (d_model "
        f"{cfg.d_model}, d_ff {cfg.d_ff}, vocab {cfg.vocab}): {n_params:,} "
        f"parameters, {res['state_gb']:.2f} GB of float32 parameters, "
        f"gradients, m and v; batch {T1_BATCH} x {T1_SEQ}, remat, lr {T1_LR}")
    log(f"  T1 losses {[round(x, 4) for x in losses]}; step ms "
        f"{[round(x * 1e3, 2) for x in secs]} (first includes warm-up); "
        f"median of steps 2-{T1_STEPS} {steady * 1e3:.2f} ms "
        f"({res['tokens_per_s']:.1f} tokens/s); peak "
        f"{res['peak_gb']:.2f} GB allocated; bound {bound:.2f} ms "
        f"({parts['bf16_matmul_ms']:.2f} bf16 matmuls, "
        f"{parts['f32_attention_ms']:.2f} float32 attention, "
        f"{parts['adamw_bytes_ms']:.2f} AdamW bytes); one more step by "
        f"CUDA events: loss and backward {split['loss_backward_ms']:.2f} "
        f"ms, AdamW {split['adamw_ms']:.2f} ms")
    del state, step, params
    lm_free()
    return res


def _train_losses(out):
    return {int(ln.split()[1]): float(ln.split("loss=")[1].split()[0])
            for ln in out.splitlines() if ln.startswith("step")}


def run_train_t2():
    """T2: ``python -m repro_torch.launch.train --arch xlstm_125m`` (full
    configuration) with checkpoints; the run's last checkpoint is lost,
    and ``--resume`` continues from step T2_RESUME_AT."""
    import shutil
    ckdir = os.path.join(REPO, "build", "t2_ckpt")
    shutil.rmtree(ckdir, ignore_errors=True)
    base = ["repro_torch.launch.train", "--arch", "xlstm_125m", "--steps",
            str(T2_STEPS), "--batch", str(T2_BATCH), "--seq", str(T2_SEQ),
            "--ckpt-dir", ckdir, "--log-every", "1"]
    _, out_a, secs_a = run_cli(base + ["--ckpt-every", str(T2_CKPT_EVERY)],
                               600)
    full = _train_losses(out_a)
    assert sorted(full) == list(range(1, T2_STEPS + 1)), out_a
    assert f"done: {T2_STEPS} steps" in out_a, out_a
    assert full[T2_STEPS] < full[1], f"T2: loss did not fall: {full}"
    with open(os.path.join(ckdir, f"step_{T2_RESUME_AT:08d}",
                           "manifest.json")) as f:
        cursor = json.load(f)["extra"]["pipeline"]
    assert cursor == {"seed": 0, "step": T2_RESUME_AT}, cursor
    shutil.rmtree(os.path.join(ckdir, f"step_{T2_STEPS:08d}"))
    _, out_b, secs_b = run_cli(base + ["--resume"], 600)
    assert out_b.splitlines()[0] == f"resumed from step {T2_RESUME_AT}", out_b
    resumed = _train_losses(out_b)
    assert sorted(resumed) == list(range(T2_RESUME_AT + 1, T2_STEPS + 1))
    assert resumed[T2_RESUME_AT + 1] == full[T2_RESUME_AT + 1], (resumed,
                                                                 full)
    gaps = [abs(resumed[i] - full[i]) for i in resumed]
    assert max(gaps) <= T2_RESUME_TOL, gaps
    with open(os.path.join(ckdir, f"step_{T2_STEPS:08d}",
                           "manifest.json")) as f:
        end = json.load(f)["extra"]["pipeline"]
    assert end == {"seed": 0, "step": T2_STEPS}, end
    times = [float(ln.split("(")[1].split("s/step")[0])
             for ln in out_a.splitlines() if ln.startswith("step")]
    res = {"first_loss": full[1], "last_loss": full[T2_STEPS],
           "resumed_losses": [resumed[i] for i in sorted(resumed)],
           "uninterrupted_losses": [full[i] for i in sorted(resumed)],
           "max_resume_gap": max(gaps), "run_s": secs_a, "resume_s": secs_b,
           "s_per_step": times[-1]}
    log(f"  launch.train --arch xlstm_125m --steps {T2_STEPS} --batch "
        f"{T2_BATCH} --seq {T2_SEQ} --ckpt-every {T2_CKPT_EVERY}: "
        f"{secs_a:.1f} s, loss {full[1]:.4f} -> {full[T2_STEPS]:.4f}, "
        f"{times[-1]:.3f} s/step (mean over the run); step {T2_STEPS}'s "
        f"checkpoint removed, --resume: {secs_b:.1f} s, resumed from step "
        f"{T2_RESUME_AT} with pipeline cursor {cursor['step']}, steps "
        f"{T2_RESUME_AT + 1}-{T2_STEPS} against the uninterrupted run: "
        f"first equal, max gap {max(gaps):.4f} (bound {T2_RESUME_TOL}); "
        f"final cursor {end['step']}")
    return res


def run_train_t3(configs, registry, pipeline, loop, optimizer, dev):
    """T3: the ten reduced configs in float32, the loss's gradients and
    one make_train_step step on the card and on the CPU from the same
    weights."""
    assert not torch.backends.cuda.matmul.allow_tf32, \
        "float32 checks need TF32 off for matmuls"
    ocfg = optimizer.OptConfig(lr=T3_LR, warmup_steps=1, total_steps=6)
    results = {}
    for arch in configs.ARCHS:
        cfg = replace(configs.get_reduced(arch), dtype="float32")
        m = registry.get_model(cfg)
        b = train_pipe(pipeline, registry, cfg, 2, 16).next()
        out = []
        for d in (torch.device("cpu"), dev):
            params = loop.init_train_state(cfg, SEED, "cpu")["params"].to(d)
            state = {"params": params,
                     "opt": optimizer.init_opt_state(params),
                     "step": torch.zeros((), dtype=torch.int32, device=d)}
            batch = {k: torch.as_tensor(v).to(d) for k, v in b.items()}
            batch = {k: v.long() if v.dtype == torch.int32 else v
                     for k, v in batch.items()}
            m.loss_fn(params, batch, cfg, remat=True).backward()
            grads = [(p.grad if p.grad is not None
                      else torch.zeros_like(p)).cpu()
                     for p in params.parameters()]
            params.zero_grad(set_to_none=True)
            state, met = loop.make_train_step(cfg, ocfg)(state, batch)
            out.append((float(met["loss"]), float(met["grad_norm"]), grads,
                        [p.detach().cpu() for p in
                         state["params"].parameters()]))
        (l0, n0, g0, p0), (l1, n1, g1, p1) = out
        floor = T3_GRAD_REL * max(float(g.abs().max()) for g in g0)
        r = {"loss": l1, "loss_gap": abs(l1 - l0) / abs(l0),
             "grad_norm_gap": abs(n1 - n0) / abs(n0),
             "grad_gap": max(float((a - b).abs().max())
                             / max(float(a.abs().max()), floor)
                             for a, b in zip(g0, g1)),
             "param_gap_lr": max(float((a - b).abs().max())
                                 for a, b in zip(p0, p1)) / T3_LR}
        assert r["loss_gap"] < T3_LOSS_REL and \
            r["grad_norm_gap"] < T3_LOSS_REL, (arch, r)
        assert r["grad_gap"] < T3_GRAD_REL, (arch, r)
        assert r["param_gap_lr"] <= T3_STEP_FRAC, (arch, r)
        results[arch] = r
    log("  card against CPU, [loss, grad norm, gradient leaf, parameter "
        "after a step]: " + json.dumps(
            {a: [float(f"{r[k]:.3g}") for k in ("loss_gap", "grad_norm_gap",
                                               "grad_gap", "param_gap_lr")]
             for a, r in results.items()}) + f" (bounds {T3_LOSS_REL} "
        f"relative, {T3_LOSS_REL} relative, {T3_GRAD_REL} of the leaf's "
        f"max-abs, {T3_STEP_FRAC} lr)")
    return results


def run_train_t4(configs, loop, optimizer, secure_agg, admm, mesh,
                 make_lasso, dev):
    """T4: the Gamma-compressed DP step (bits 8, error feedback) and SPMD
    ADMM on a one-rank NCCL process group on the card."""
    import torch.distributed as dist
    res = {}
    with mesh.process_group(dev, 1, 0) as group:
        assert dist.get_backend(group) == "nccl", dist.get_backend(group)
        cfg = replace(configs.get_reduced("yi_9b"), dtype="float32")
        step = loop.make_dp_compressed_step(
            cfg, optimizer.OptConfig(lr=5e-3, warmup_steps=1,
                                     total_steps=20), group,
            secure_agg.CompressionConfig(bits=8, enabled=True,
                                         error_feedback=True))
        state = loop.init_dp_state(cfg, SEED, dev)
        rng = np.random.default_rng(0)
        batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab, (4, 16)),
                                    device=dev)
                 for k in ("tokens", "labels")}
        losses = []
        for _ in range(8):
            state, met = step(state, batch)
            losses.append(float(met["loss"]))
        assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
        res["dp_losses"] = losses
        inst = make_lasso(40, 160, 0.05, 0.01, seed=1)
        cpu_group = dist.new_group(ranks=[0], backend="gloo")
        for coupled in (False, True):
            acfg = admm.ADMMConfig(lam=0.05, iters=100, coupled=coupled)
            x, objs = admm.make_spmd_admm(group, acfg, 1)(
                torch.as_tensor(inst.A, device=dev), inst.y)
            assert x.device.type == dev.type
            xc, oc = admm.make_spmd_admm(cpu_group, acfg, 1)(inst.A, inst.y)
            gap = max(float((x.cpu() - xc).abs().max()),
                      float((objs.cpu() - oc).abs().max()
                            / oc.abs().max()))
            assert gap < T4_ADMM_TOL, (coupled, gap)
            res[f"admm_{'coupled' if coupled else 'uncoupled'}_gap"] = gap
        dist.destroy_process_group(cpu_group)
    assert not dist.is_initialized()
    log(f"  make_dp_compressed_step on NCCL (1 rank), bits 8, error "
        f"feedback, reduced yi_9b: losses {[round(x, 4) for x in losses]}; "
        f"make_spmd_admm (float64, 100 iterations) against its gloo run on "
        f"the CPU: uncoupled {res['admm_uncoupled_gap']:.3g}, coupled "
        f"{res['admm_coupled_gap']:.3g} (bound {T4_ADMM_TOL}); group torn "
        f"down")
    return res


def run_train_phase(dev):
    from repro_torch import configs
    from repro_torch.core import admm, secure_agg
    from repro_torch.data import pipeline
    from repro_torch.data.synthetic import make_lasso
    from repro_torch.launch import mesh
    from repro_torch.models import registry
    from repro_torch.train import loop, optimizer
    t0 = time.perf_counter()
    tr = {}
    log(f"train T1: yi_9b at full width, {T1_LAYERS} layers, "
        f"make_train_step:")
    tr["t1"] = run_train_t1(configs, registry, pipeline, loop, optimizer,
                            dev)
    log("train T2: python -m repro_torch.launch.train --arch xlstm_125m, "
        "then --resume:")
    tr["t2"] = run_train_t2()
    log("train T3: the ten reduced configs in float32, one step, card "
        "against CPU:")
    tr["t3"] = run_train_t3(configs, registry, pipeline, loop, optimizer,
                            dev)
    log("train T4: the compressed DP step and SPMD ADMM on NCCL:")
    tr["t4"] = run_train_t4(configs, loop, optimizer, secure_agg, admm,
                            mesh, make_lasso, dev)
    tr["phase_s"] = time.perf_counter() - t0
    log(f"  train phase: {tr['phase_s']:.1f} s")
    return tr, tr["t1"].pop("snapshot")


# ---------------------------------------------------------------------------
# 2-D sharding and the dry-run: DTensor parameters at param_pspecs's
# placements, and launch.dryrun on a fake process group (plain PyTorch
# and torch.distributed; no kernel)
# ---------------------------------------------------------------------------

#: D1: T1's first steps on a 1 x 1 mesh: loss relative to T1's, and each
#: parameter after them in units of T1's peak lr (T3's bound)
D1_STEPS, D1_LOSS_REL, D1_STEP_FRAC = 3, 1e-3, 0.5
#: D2: the dry-run's predicted peak against T1's measured one, and its
#: counted bf16 matmul flops against train_step_bound's
D2_PEAK_REL, D2_FLOPS_REL = 0.15, 0.03
#: D3: the production dry-run's subprocesses and their time limit (s)
D3_RUNS = {"yi_9b": ["--arch", "yi_9b"],
           "qwen2_moe_a27b": ["--arch", "qwen2_moe_a27b", "--shape",
                              "train_4k"]}
D3_TIMEOUT = 600
H100_GB = 80


def run_shard_d1(configs, registry, pipeline, loop, optimizer, mesh, L,
                 t1, snapshot, dev):
    """D1: T1's model, weights and batches as DTensors on a 1 x 1
    ("data", "model") mesh over a one-rank NCCL group, D1_STEPS steps."""
    import torch.distributed as dist
    from torch.distributed.tensor import Shard
    cfg = replace(configs.get_config("yi_9b"), n_layers=T1_LAYERS)
    ocfg = optimizer.OptConfig(lr=T1_LR, warmup_steps=1,
                               total_steps=T1_STEPS)
    with mesh.process_group(dev, 1, 0) as group:
        assert dist.get_backend(group) == "nccl", dist.get_backend(group)
        dmesh = mesh.make_mesh((1, 1), ("data", "model"), dev)
        state = loop.init_train_state(cfg, SEED, dev)
        specs = registry.param_pspecs(cfg, state["params"],
                                      mesh.mesh_shape_dict(dmesh))
        state = loop.shard_train_state(state, dmesh, specs)
        lm_free()
        torch.cuda.reset_peak_memory_stats()
        L.set_activation_sharding(dmesh, [Shard(0), Shard(2)])
        try:
            step = loop.make_train_step(cfg, ocfg, remat=True)
            pipe = train_pipe(pipeline, registry, cfg, T1_BATCH, T1_SEQ)
            losses, secs = [], []
            for _ in range(D1_STEPS):
                batch = pipe.next(device=dev, mesh=dmesh)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, met = step(state, batch)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
                losses.append(float(met["loss"]))
        finally:
            L.set_activation_sharding(None)
        peak = torch.cuda.max_memory_allocated() / 1e9
        wq = state["params"]["layers"][0]["attn"]["wq"]
        placements = [str(p) for p in wq.placements]
        param_gap = max(
            float((p.detach().to_local().cpu() - ref).abs().max())
            for p, ref in zip(state["params"].parameters(), snapshot))
        del state, step
    lm_free()
    loss_gaps = [abs(a - b) / abs(b) for a, b in zip(losses, t1["losses"])]
    res = {"losses": losses, "t1_losses": t1["losses"][:D1_STEPS],
           "loss_gap_rel": max(loss_gaps), "param_gap_lr": param_gap / T1_LR,
           "step_ms": [x * 1e3 for x in secs],
           "median_step_ms": float(np.median(secs[1:])) * 1e3,
           "t1_median_step_ms": t1["median_step_ms"], "peak_gb": peak,
           "wq_placements": placements}
    log(f"  yi_9b, {T1_LAYERS} layers, batch {T1_BATCH} x {T1_SEQ}, on a "
        f"1 x 1 mesh (wq at {placements}): losses "
        f"{[round(x, 5) for x in losses]} against T1's "
        f"{[round(x, 5) for x in res['t1_losses']]}: largest gap "
        f"{res['loss_gap_rel']:.3g} relative (bound {D1_LOSS_REL}); "
        f"parameters after {D1_STEPS} steps within "
        f"{res['param_gap_lr']:.3g} lr of T1's (bound {D1_STEP_FRAC}); "
        f"step ms {[round(x * 1e3, 1) for x in secs]} (first includes "
        f"DTensor's sharding propagation), median of steps 2-{D1_STEPS} "
        f"{res['median_step_ms']:.1f} ms against T1's "
        f"{t1['median_step_ms']:.1f} ms; peak {peak:.2f} GB allocated")
    assert res["loss_gap_rel"] <= D1_LOSS_REL, res
    assert res["param_gap_lr"] <= D1_STEP_FRAC, res
    return res


def run_shard_d2(configs, mesh, dryrun, t1):
    """D2: the dry-run's accounting of T1's step (T1's model, batch and
    sequence, remat, no accumulation) on a fake one-rank mesh."""
    cfg = replace(configs.get_config("yi_9b"), n_layers=T1_LAYERS)
    t0 = time.perf_counter()
    with mesh.fake_group(1):
        dmesh = mesh.make_mesh((1, 1), ("data", "model"), "cuda")
        e = dryrun.run_cell("yi_9b", "t1", dmesh, report={}, cfg=cfg,
                            shape=dict(kind="train", seq=T1_SEQ,
                                       batch=T1_BATCH), accum=1)
    assert e["status"] == "ok", e
    peak = e["memory"]["peak_bytes_per_dev"] / 1e9
    flops = e["flops_by_dtype"]["bfloat16"] / 1e12
    bound = t1["bound_parts"]["bf16_tflop"]
    res = {"predicted_peak_gb": peak, "t1_peak_gb": t1["peak_gb"],
           "peak_gap_rel": abs(peak - t1["peak_gb"]) / t1["peak_gb"],
           "counted_bf16_tflop": flops, "bound_bf16_tflop": bound,
           "flops_gap_rel": abs(flops - bound) / bound,
           "flops_by_dtype": e["flops_by_dtype"],
           "bytes_per_dev": e["bytes_per_dev"],
           "roofline": e["roofline"], "s": time.perf_counter() - t0}
    log(f"  predicted peak {peak:.2f} GB against T1's measured "
        f"{t1['peak_gb']:.2f} GB (gap {res['peak_gap_rel']:.3g}, bound "
        f"{D2_PEAK_REL}); counted bf16 matmuls {flops:.3f} TFLOP against "
        f"train_step_bound's {bound:.3f} (gap {res['flops_gap_rel']:.3g}, "
        f"bound {D2_FLOPS_REL}); float32 "
        f"{e['flops_by_dtype'].get('float32', 0) / 1e12:.3f} TFLOP; "
        f"{res['s']:.1f} s")
    assert res["peak_gap_rel"] <= D2_PEAK_REL, res
    assert res["flops_gap_rel"] <= D2_FLOPS_REL, res
    return res


def start_shard_d3():
    """Start D3: ``python -m repro_torch.launch.dryrun`` on the fake 16 x
    16 mesh, D3_RUNS side by side.  They run on meta tensors, on the host
    alone, so they run beside the examples phase; :func:`run_shard_d3`
    waits for them and :func:`stop_shard_d3` stops them."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    outs = {name: os.path.join(REPO, "build", f"dryrun_{name}.json")
            for name in D3_RUNS}
    started = dict(outs=outs, procs={}, t0=time.perf_counter())
    try:
        for name, args in D3_RUNS.items():
            started["procs"][name] = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", *args,
                 "--out", outs[name]], stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True, env=env, cwd=REPO)
    except BaseException:
        stop_shard_d3(started)
        raise
    return started


def stop_shard_d3(started):
    """Stop every D3 process still running."""
    for p in started["procs"].values():
        if p.poll() is None:
            p.kill()
            p.wait()


def run_shard_d3(started):
    """D3: wait for the dry-runs :func:`start_shard_d3` started (every
    process is stopped on the way out) and check their cells."""
    procs, outs, t0 = started["procs"], started["outs"], started["t0"]
    try:
        done = {name: p.communicate(timeout=D3_TIMEOUT)
                for name, p in procs.items()}
    finally:
        stop_shard_d3(started)
    secs = time.perf_counter() - t0
    cells = {}
    for name, p in procs.items():
        assert p.returncode == 0, (
            f"dryrun {name} exited {p.returncode}:\n"
            f"{done[name][0][-3000:]}\n{done[name][1][-3000:]}")
        with open(outs[name]) as f:
            cells.update(json.load(f))
    bad = {k: v for k, v in cells.items()
           if v["status"] not in ("ok", "skipped")}
    assert not bad, bad
    assert cells["qwen2_moe_a27b/train_4k/16x16"]["collectives"][
        "counts"].get("all-gather"), "expert parallelism recorded nothing"
    res = {"s": secs, "cells": {}}
    for key, v in cells.items():
        if v["status"] != "ok":
            res["cells"][key] = v
            log(f"  {key}: skipped ({v['reason']})")
            continue
        rl = v["roofline"]
        res["cells"][key] = {
            "peak_gb_per_dev": v["memory"]["peak_bytes_per_dev"] / 1e9,
            "bottleneck": rl["bottleneck"], "t_compute": rl["t_compute"],
            "t_memory": rl["t_memory"], "t_collective": rl["t_collective"],
            "flops_per_dev": v["flops_per_dev"],
            "bytes_per_dev": v["bytes_per_dev"],
            "coll_bytes_per_dev": v["coll_bytes_per_dev"],
            "collectives": v["collectives"]["counts"],
            "useful_ratio": rl["useful_ratio"], "run_s": v["run_s"]}
        c = res["cells"][key]
        log(f"  {key}: peak {c['peak_gb_per_dev']:.2f} GB per card (H100: "
            f"{H100_GB} GB), {c['bottleneck']}-bound: compute "
            f"{c['t_compute']:.4g} s, memory {c['t_memory']:.4g} s, "
            f"collective {c['t_collective']:.4g} s; collectives "
            f"{c['collectives']}; run {c['run_s']} s")
    log(f"  two dry-run subprocesses side by side, beside the examples: "
        f"{secs:.1f} s")
    return res


def run_shard_phase(dev, t1, snapshot):
    from repro_torch import configs
    from repro_torch.data import pipeline
    from repro_torch.launch import dryrun, mesh
    from repro_torch.models import layers as L
    from repro_torch.models import registry
    from repro_torch.train import loop, optimizer
    t0 = time.perf_counter()
    sh = {}
    log(f"shard D1: T1's step with DTensor parameters on a 1 x 1 mesh, "
        f"{D1_STEPS} steps against T1's:")
    sh["d1"] = run_shard_d1(configs, registry, pipeline, loop, optimizer,
                            mesh, L, t1, snapshot, dev)
    log("shard D2: the dry-run's accounting of T1's step against T1:")
    sh["d2"] = run_shard_d2(configs, mesh, dryrun, t1)
    sh["phase_s"] = time.perf_counter() - t0
    log(f"  shard phase: {sh['phase_s']:.1f} s")
    return sh



# ---------------------------------------------------------------------------
# The port's examples (E) and the multi-card batch split (M)
# ---------------------------------------------------------------------------

#: E: the six examples, in the reference's order, each through its main
EXAMPLES = ("quickstart", "edge_network_sim", "workload_zoo",
            "power_grid_reconstruction", "serve_batched", "train_lm_secure")
#: M: the split rehearsed over this card twice
SPLIT_CARDS = 2


def _gold_equals_plain(protocol, res, cfg, inst, **kw):
    plain = protocol.run_protocol(inst.A, inst.y,
                                  replace(cfg, cipher="plain"), **kw)
    assert res.history.tobytes() == plain.history.tobytes(), cfg.workload


def run_examples_e(build, protocol):
    """E: ``python -m repro_torch.examples.<name>``'s ``main`` for each
    of the six examples on the card, in this process (``train_lm_secure``
    in its smoke mode), each with the launch counts set to 0 just before
    it and read just after: each passes its own asserts and prints ``OK``;
    the gold examples' histories equal their plain arms' bit for bit."""
    import importlib
    res = {}
    for name in EXAMPLES:
        mod = importlib.import_module(f"repro_torch.examples.{name}")
        out = io.StringIO()
        build.reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            got = mod.main([])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counted = dict(build.LAUNCHES)
        launches = {b: n for b, n in counted.items() if n}
        lines = out.getvalue().splitlines()
        assert lines and lines[-1].startswith("OK"), (name, lines[-3:])
        for line in lines:
            log(f"  {name}| {line}")
        if name == "quickstart":
            _gold_equals_plain(protocol, got, got.cfg, got.inst)
        elif name == "workload_zoo":
            for row in got:
                _gold_equals_plain(protocol, row["result"], row["cfg"],
                                   row["inst"], workload=row["workload"])
        if name in ("quickstart", "workload_zoo"):
            check_launches(f"example {name}", counted, MAIN_PATH_BODIES)
        res[name] = {"wall_s": wall, "launches": launches}
        log(f"  {name}: OK in {wall:.2f} s; launches {json.dumps(launches)}"
            + ("; gold history equals the plain arm's"
               if name in ("quickstart", "workload_zoo") else ""))
    return res


def run_split_m(key, build, pb, dispatch):
    """M: on one card ``kernel_mesh`` is None and ``device_kind`` has no
    ``xN`` suffix; then one main-path round's batched ops (enc of Nk
    plaintexts, the (Nk, Nk) matvec, dec of its Nk rows) run whole and
    split over ``[cuda:0] * SPLIT_CARDS``: equal ciphertexts, plaintexts
    and rng state, and every launch made inside a CRT body made again
    per chunk (batch / SPLIT_CARDS, count x SPLIT_CARDS)."""
    from collections import Counter
    from repro_torch.launch import mesh
    assert mesh.kernel_mesh() is None, mesh.kernel_mesh()
    kind = dispatch.device_kind()
    assert kind == "torch-cuda-" + torch.cuda.get_device_name(0).replace(
        "/", "-"), kind
    bk = pb.make_batch_key(key, DEVICE)
    rng = np.random.default_rng(SEED)
    ms = [int(v) for v in rng.integers(0, 2 ** 62, NK)]
    Ks = rng.integers(0, 2 ** 50, (1, NK, NK)).astype(object)

    def round_ops():
        r = random.Random(SEED)
        ct = pb.enc_ct(bk, ms, r)
        mv = pb.matvec_many(bk, Ks, [ct])[0]
        out = (ct.to_ints(), mv.to_ints(), pb.dec_vec(bk, mv), r.getstate())
        torch.cuda.synchronize()
        return out

    inside = Counter()
    real_split = pb._run_split

    def recording_split(body, *arrays, group=1):
        before = Counter(build.SHAPE_LAUNCHES)
        out = real_split(body, *arrays, group=group)
        inside.update(Counter(build.SHAPE_LAUNCHES) - before)
        return out

    round_ops()                                   # warm both paths' shapes
    res = {"kernel_mesh": None, "device_kind": kind}
    build.reset_launches()
    pb._run_split = recording_split
    try:
        t0 = time.perf_counter()
        whole = round_ops()
        res["whole_s"] = time.perf_counter() - t0
    finally:
        pb._run_split = real_split
    whole_shapes = Counter(build.SHAPE_LAUNCHES)
    whole_launches = dict(build.LAUNCHES)
    real_mesh = mesh.kernel_mesh
    mesh.kernel_mesh = lambda device=None: [torch.device("cuda", 0)] \
        * SPLIT_CARDS
    try:
        round_ops()
        build.reset_launches()
        t0 = time.perf_counter()
        split = round_ops()
        res["split_s"] = time.perf_counter() - t0
    finally:
        mesh.kernel_mesh = real_mesh
    assert split == whole, "the split round differs from the whole one"
    want = Counter()
    for (body, B, k), n in whole_shapes.items():
        want[(body, B, k)] += n - inside[(body, B, k)]
        want[(body, B // SPLIT_CARDS, k)] += SPLIT_CARDS * inside[
            (body, B, k)]
    got = Counter(build.SHAPE_LAUNCHES)
    assert +got == +want, (sorted(got.items()), sorted(want.items()))
    for body in ("modexp[montgomery,win4]", "modexp_fixed[montgomery]"):
        assert build.LAUNCHES[body] == SPLIT_CARDS * whole_launches[body] \
            > 0, (body, build.LAUNCHES[body], whole_launches[body])
    res["launches"] = {b: [whole_launches[b], build.LAUNCHES[b]]
                       for b in whole_launches if whole_launches[b]}
    res["inside"] = {f"{b} B={B} k={k}": n for (b, B, k), n in
                     sorted(inside.items())}
    log(f"  one card: kernel_mesh() is None, device_kind() = {kind}")
    log(f"  one main-path round's batched ops (Nk = {NK}, {KEY_BITS}-bit "
        f"key) whole and split over {SPLIT_CARDS} x cuda:0: ciphertexts, "
        f"plaintexts and rng state equal; launches [whole, split] "
        f"{json.dumps(res['launches'])}; launches inside the CRT bodies "
        f"(whole) {json.dumps(res['inside'])}; wall whole "
        f"{res['whole_s']:.3f} s, split {res['split_s']:.3f} s")
    return res


def run_port_phase(key, build, pb, protocol, dispatch):
    t0 = time.perf_counter()
    ex = {}
    log("examples E: python -m repro_torch.examples.<name>'s main for each "
        "of the six, on the card:")
    ex["e"] = run_examples_e(build, protocol)
    log("multi-card M: kernel_mesh and device_kind on one card, and the "
        "batch split rehearsed over one card twice:")
    ex["m"] = run_split_m(key, build, pb, dispatch)
    ex["phase_s"] = time.perf_counter() - t0
    log(f"  examples and split phase: {ex['phase_s']:.1f} s")
    return ex


def main():
    require_card()
    sys.path.insert(0, os.path.join(REPO, "src"))
    from repro_torch import workloads
    from repro_torch.core import bigint as bi
    from repro_torch.core import churn as churn_mod
    from repro_torch.core import paillier as gold
    from repro_torch.core import paillier_batch as pb
    from repro_torch.core import protocol
    from repro_torch.core.quantization import QuantSpec
    from repro_torch.data.synthetic import make_lasso
    from repro_torch.kernels import build, geometry, ops
    from repro_torch.kernels import limb_mulmod as lm
    from repro_torch.kernels import modexp as mx
    from repro_torch.kernels import montgomery as mg
    from repro_torch.obs.metrics import diff_reports, report_core
    from repro_torch.runtime import LinkModel, dispatch, runner
    from repro_torch.serve.protocol_engine import ProtocolEngine
    dev = torch.device("cuda")
    # the run-history ledger and the calibration cache stay in the checkout
    os.environ["REPRO_LEDGER"] = os.path.join(REPO, "build", "ledger.jsonl")
    calib = os.path.join(REPO, "build", "dispatch_calib.json")
    t_start = time.perf_counter()

    ptxas = build_kernels(build)
    key = gold.keygen(KEY_BITS, random.Random(SEED))
    log("kernels vs plain versions on the card:")
    packs = check_kernels(key, bi, ops, mg, lm, mx, dev)
    log("kernels vs plain versions at main-path shapes, timed:")
    times, sweep, pair, shapes = time_kernels(key, packs, bi, geometry, mg,
                                              lm, mx, dev)
    log("group sizes: " + json.dumps(sweep))
    log("two-half launch: " + json.dumps(pair))

    log(f"main path: gold LASSO, {KEY_BITS}-bit key, Delta={DELTA:g}, "
        f"K={K}, N={N}, M={M}, iters={ITERS}")
    plain_history = run_plain(protocol, QuantSpec, make_lasso)
    res, wall, launches, shape_launches, checked, gold_box = run_main_path(
        protocol, gold, bi, build, QuantSpec, make_lasso, plain_history,
        MAIN_PATH_BODIES)
    secs = res.stats["seconds"]
    report_path(wall, secs, checked, launches, shape_launches)
    check_one_tree("main path", launches, "modexp[montgomery,win4]",
                   "prod_rows[montgomery]")

    log("time split of one main-path round (torch.profiler):")
    split = time_split(protocol, lm, mx, QuantSpec, make_lasso,
                       res.history[0], float(np.median(secs["rounds"])))
    log("split: " + json.dumps(split))

    log(f"one round at N={N_SCALED} (Nk={N_SCALED // K}):")
    scaled = run_scaled(protocol, QuantSpec, make_lasso)
    log(f"  share {scaled['share']:.3f} s, round "
        f"{scaled['rounds'][0]:.4f} s; history equals the plain arm")

    # after the Montgomery phases, so none of their timings follows it
    log("main path under REPRO_REDUCE_IMPL=barrett:")
    with environ("REPRO_REDUCE_IMPL", "barrett"):
        bres, bwall, blaunches, bshape_launches, bchecked, _ = run_main_path(
            protocol, gold, bi, build, QuantSpec, make_lasso, plain_history,
            BARRETT_ARM_BODIES,
            absent=[b for b in geometry.BODIES if "montgomery" in b
                    and b not in geometry.TREE_BODIES])
    report_path(bwall, bres.stats["seconds"], bchecked, blaunches,
                bshape_launches)
    check_one_tree("Barrett arm", blaunches, "modexp[barrett,win4]",
                   "prod_rows[montgomery]")

    # the protocol surface, after every earlier phase
    log("modexp at this slice's new shapes, timed:")
    new_shapes = time_new_shapes(key, packs, bi, geometry, mx, ptxas, dev)
    surface = {}
    log("vec arm of the main path:")
    vec_res, surface["vec_arm"], vshapes = run_vec_arm(
        protocol, gold, bi, build, QuantSpec, make_lasso, plain_history,
        gold_box)
    log("Algorithm 3 (collaborative=True) on the main path's instance:")
    _, surface["collab"], cshapes, enc_launches = run_collaborative(
        protocol, gold, pb, build, QuantSpec, make_lasso, plain_history,
        shape_launches)
    log(f"the other families, gold arm, {KEY_BITS}-bit keys, Nk={NK}:")
    families, surface["families"], fshapes = run_families(protocol, build,
                                                          workloads)
    log(f"churn: LASSO gold, quarter schedule over {CHURN_ITERS} "
        f"iterations, recycle=True:")
    _, surface["churn"], hshapes = run_churn(protocol, churn_mod, build,
                                             QuantSpec, make_lasso)
    log("health watchers on the gold main path:")
    _, surface["health"], lshapes = run_health(protocol, build, QuantSpec,
                                               make_lasso, plain_history)
    log("families: " + json.dumps(families))

    # the event-driven runtime, after every earlier phase; each kernel
    # shape that none of them launched is sampled and timed
    seen = set(shape_launches) | set(bshape_launches) | set(vshapes) \
        | set(cshapes) | set(fshapes) | set(hshapes) | set(lshapes)
    runtime = {}
    with ShapeRecorder(mx, lm, geometry, seen) as recorder:
        log(f"runtime, sync mode, gold arm, star, K={K}:")
        _, runtime["rt_gold"], rgshapes = run_runtime_sync(
            runner, protocol, QuantSpec, make_lasso, report_core, build,
            "gold", plain_history, report_core(res.stats))
        log(f"runtime, sync mode, vec arm, star, K={K}:")
        _, runtime["rt_vec"], rvshapes = run_runtime_sync(
            runner, protocol, QuantSpec, make_lasso, report_core, build,
            "vec", plain_history, report_core(vec_res.stats))
        log(f"runtime, deadline mode ({DEADLINE} s), gold arm, edge "
            f"{SLOW_EDGE} 10x slow behind a {SLOW_LINK_S} s link, "
            f"coalesce_hold_ticks='auto':")
        _, runtime["rt_deadline"], rdshapes = run_runtime_deadline(
            runner, protocol, QuantSpec, make_lasso, LinkModel, build)
        log(f"runtime, cipher='auto', calibrated on the card "
            f"(key_bits={KEY_BITS}, batch {NK}):")
        (_, runtime["rt_auto"], rashapes, calib_s,
         routes) = run_runtime_auto(runner, dispatch, protocol, QuantSpec,
                                    make_lasso, build, plain_history, calib)
    runtime_shapes = recorder.check()
    log("new launch shapes of the runtime paths, each equal to its plain "
        "version on sample rows: " + json.dumps(runtime_shapes))
    log("python -m repro_torch.launch.edge_sim --backend auto:")
    edge_sim_s = run_edge_sim(calib)
    rt_shape_launches = {"rt_gold": rgshapes, "rt_vec": rvshapes,
                         "rt_deadline": rdshapes, "rt_auto": rashapes}
    log("runtime: " + json.dumps({
        "calibrate_s": calib_s, "auto_routes": routes,
        "edge_sim_s": edge_sim_s, "launches": runtime}))

    # the serving path, after every earlier phase
    log("per-row-modulus kernels vs plain versions at n^2, timed:")
    times.update(time_rows_kernels(bi, ops, lm, mx, geometry, ptxas, dev))
    log("mulmod_rows at S1's and S2's shapes, both bodies in turns, their "
        "group and block sizes, and the Montgomery body on one modulus "
        "beside mulmod:")
    t0 = time.perf_counter()
    mulmod_turns, mulmod_sweep, mulmod_single = time_mulmod_rows_s1(
        bi, ops, lm, geometry, ptxas, dev)
    log(f"mulmod_rows at S1's shapes: {time.perf_counter() - t0:.1f} s; "
        f"sweep " + json.dumps(mulmod_sweep) + "; one modulus "
        + json.dumps(mulmod_single))
    log("per-row ModExp at S1's shapes, Barrett and Montgomery in turns, "
        "and the Montgomery bodies' group and block sizes:")
    t0 = time.perf_counter()
    rows_turns, rows_sweep = time_rows_s1(bi, ops, mx, geometry, ptxas, dev)
    log(f"rows at S1's shapes: {time.perf_counter() - t0:.1f} s; sweep "
        + json.dumps(rows_sweep))
    log("the product-tree kernel at S1's, the main path's and the "
        "runtime's matvecs and on an even modulus, in turns with the tree "
        "of mulmods it replaced, and its sweep:")
    t0 = time.perf_counter()
    prod_tree, tree_sweep = time_prod_rows(bi, ops, geometry, ptxas, dev)
    log(f"product tree: {time.perf_counter() - t0:.1f} s; sweep "
        + json.dumps(tree_sweep))
    for row in prod_tree:                      # the main path's shape
        if row["what"] == "main":
            times[row["body"]] = dict(row, shape=(
                f"R={row['B']} N={row['factors']} k=128, one modulus"))
    serving, serve_launches = {}, {}
    with LaunchRecorder(mx, lm, geometry) as launch_rec:
        log(f"serving S1: ProtocolEngine, {len(SERVE_SEEDS)} gold LASSO "
            f"tenants, {KEY_BITS}-bit keys, K={K}, Nk={NK}, "
            f"{SERVE_ITERS} rounds each, against their solo runs:")
        (serving["s1"], solos, serve_launches["serve_s1"], s1_shapes,
         s1_timed) = run_serve_s1(
            runner, protocol, QuantSpec, make_lasso, report_core,
            diff_reports, build, ProtocolEngine, launch_rec, plain_history)
        log("serving S2: 2,048- and 1,024-bit gold tenants, a vec tenant, "
            "a staggered and a cancelled tenant:")
        (serving["s2"], serve_launches["serve_s2"], s2_shapes,
         s2_timed) = run_serve_s2(
            runner, protocol, QuantSpec, make_lasso, report_core,
            diff_reports, build, ProtocolEngine, launch_rec, solos)
    serve_shapes = launch_rec.check_rows({**s2_timed, **s1_timed})
    log("rows launch shapes of S1 and S2, each equal to its plain version "
        "on sample rows: " + json.dumps(serve_shapes))
    log("serving S4: S1's fused rows ops under "
        "torch.cuda.set_sync_debug_mode('error'):")
    t0 = time.perf_counter()
    serving["s4"] = run_sync_s4(pb, bi, gold, [solos[f"t{s}"][1].key
                                              for s in SERVE_SEEDS])
    log(f"  S4: {time.perf_counter() - t0:.1f} s")
    log("serving S3: serve_sim, obs.report and obs.sentinel as "
        "subprocesses:")
    serving["s3"] = run_serve_clis(calib)
    serving["prod_rows"] = prod_tree
    s1_matvecs = s1_shapes.get(("modexp_rows[montgomery,win4]",
                                S1_ROWS_SHAPES[0][1], 128), 0)
    assert serve_launches["serve_s1"]["prod_rows[montgomery]"] == \
        s1_matvecs > 0, (serve_launches["serve_s1"], s1_matvecs)
    log(f"  S1: one product-tree launch per fused matvec ({s1_matvecs})")
    log("serving: " + json.dumps(serving))

    # the LM serving stack, after every earlier phase
    lm = run_lm_phase(dev)
    log("lm: " + json.dumps(lm))

    # LM training, after every earlier phase
    train, t1_snapshot = run_train_phase(dev)
    log("train: " + json.dumps(train))

    # the 2-D sharding and the dry-run, after every earlier phase
    shard = run_shard_phase(dev, train["t1"], t1_snapshot)
    del t1_snapshot

    # the examples and the batch split, after every earlier phase, with
    # D3's dry-runs (host work only) beside them
    log("shard D3: python -m repro_torch.launch.dryrun --arch yi_9b, and "
        "--arch qwen2_moe_a27b --shape train_4k, on the fake 16 x 16 mesh, "
        "started beside the examples:")
    d3 = start_shard_d3()
    try:
        port = run_port_phase(key, build, pb, protocol, dispatch)
    except BaseException:
        stop_shard_d3(d3)
        raise
    log("port: " + json.dumps(port))
    log("shard D3, waited for:")
    shard["d3"] = run_shard_d3(d3)
    log("shard: " + json.dumps(shard))

    log(f"script: {time.perf_counter() - t_start:.1f} s")

    kernels = []
    for body in geometry.BODIES:
        t = times[body]
        source, replaces = BODY_SOURCES[body]
        entry = {
            "name": body, "route": "cuda", "source": f"{CSRC}/{source}",
            "replaces": replaces,
            # this slice's bodies: their launches on the serving path (S1)
            "launches": (serve_launches["serve_s1"][body]
                         if body.startswith(("mulmod_rows", "modexp_rows"))
                         else launches[body]),
            "barrett_arm_launches": blaunches[body],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None,
            "shape": t["shape"]}
        entry.update({f"{path}_launches": surface[path][body]
                      for path in SURFACE_PATHS})
        entry["collab_encrypt_launches"] = enc_launches[body]
        entry.update({f"{path}_launches": runtime[path][body]
                      for path in RUNTIME_PATHS})
        entry.update({f"{path}_launches": serve_launches[path][body]
                      for path in SERVE_PATHS})
        entry["examples_launches"] = sum(
            e["launches"].get(body, 0) for e in port["e"].values())
        entry["split_launches"] = port["m"]["launches"].get(body, [0, 0])
        timed = [r for r in shapes if r["body"] == body]
        if len(timed) > 1:                     # each main-path shape
            entry["shapes"] = [
                {key: r[key] for key in ("B", "k", "ms", "event_ms",
                                         "plain_ms", "bound_ms", "bound_by",
                                         "max_abs_err")}
                | {"launches": shape_launches.get((body, r["B"], r["k"]),
                                                  0)}
                for r in timed]
        new = [r for r in new_shapes if r["body"] == body]
        if new:                                # this slice's new shapes
            entry.setdefault("shapes", []).extend(
                {key: r[key] for key in ("B", "k", "exp_bits", "ms",
                                         "event_ms", "plain_ms",
                                         "plain_rows", "bound_ms",
                                         "bound_by", "max_abs_err",
                                         "instantiation", "registers",
                                         "spill_stores")}
                | {"launches": shape_launches.get((body, r["B"], r["k"]), 0),
                   "vec_arm_launches": vshapes.get((body, r["B"], r["k"]),
                                                   0),
                   "collab_launches": cshapes.get((body, r["B"], r["k"]),
                                                  0)}
                for r in new)
        rt_new = [r for r in runtime_shapes if r["body"] == body]
        if rt_new:                             # the runtime's new shapes
            entry.setdefault("shapes", []).extend(
                dict(r, **{f"{path}_launches": rt_shape_launches[path].get(
                    (body, r["B"], r["k"]), 0) for path in RUNTIME_PATHS})
                for r in rt_new)
        rows_s1 = [r for r in rows_turns + mulmod_turns
                   if r["body"] == body]
        if rows_s1:                            # S1's shapes, in turns
            entry.setdefault("shapes", []).extend(
                dict(r, serve_s1_launches=s1_shapes.get(
                    (body, r["B"], r["k"]), 0),
                    serve_s2_launches=s2_shapes.get(
                        (body, r["B"], r["k"]), 0)) for r in rows_s1)
        if body == "mulmod_rows[montgomery]":  # beside mulmod, one modulus
            entry["one_modulus"] = mulmod_single
        tree = [r for r in prod_tree if r["body"] == body]
        if tree:                               # the product tree's shapes
            entry.setdefault("shapes", []).extend(
                dict(r, launches=shape_launches.get((body, r["B"], r["k"]),
                                                    0),
                     barrett_arm_launches=bshape_launches.get(
                         (body, r["B"], r["k"]), 0),
                     rt_gold_launches=rt_shape_launches["rt_gold"].get(
                         (body, r["B"], r["k"]), 0),
                     serve_s1_launches=s1_shapes.get(
                         (body, r["B"], r["k"]), 0))
                for r in tree)
        rows_new = [r for r in serve_shapes if r["body"] == body]
        if rows_new:                           # the serving path's shapes
            entry.setdefault("shapes", []).extend(
                dict(r, serve_s1_launches=s1_shapes.get(
                    (body, r["B"], r["k"]), 0),
                    serve_s2_launches=s2_shapes.get(
                        (body, r["B"], r["k"]), 0))
                for r in rows_new)
        kernels.append(entry)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
