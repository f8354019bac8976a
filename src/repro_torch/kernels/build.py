"""Build the CUDA limb kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface (``nvcc -gencode arch=compute_90a,code=sm_90a -O3
-shared``), one ``nvcc`` per source, all started together, each
optimizing its kernel instantiations on every core
(``-split-compile=0``).  Libraries are cached under
``build/repro_torch/`` at the repository root, named by a hash of the
sources and flags, so a later process loads them without rebuilding and
an edited source rebuilds.  Nothing here runs at import:
this module imports on machines without a card or a CUDA toolkit.

Launch counts: each kernel wrapper calls :func:`count_launch` where it
launches its kernel, and nowhere else: one more in ``LAUNCHES[body]`` (the
keys are the kernel bodies of ``geometry.BODIES``) and in
``SHAPE_LAUNCHES[(body, B, k)]`` (batch and width in 32-bit words).
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

from ..obs import trace
from . import geometry

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-split-compile=0")
NVCC_TIMEOUT_S = 900

_P, _I, _U, _L = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32,
                  ctypes.c_longlong)
#: the launch geometry every launcher takes: threads per integer, words
#: per thread, threads per block, blocks, dynamic shared memory bytes
_GEOM = (_I, _I, _I, _I, _I)
#: one modulus of a modexp_fixed launch: windows, m, r1 or mu, r2, mp
_HALF = (_P, _P, _P, _P, _U)
#: the kernel sources, ``csrc/<name>.cu``: one library each
SOURCES = ("mulmod", "modexp", "modexp_fixed", "prodtree")
#: launcher name -> (its source, exported C function, argument types); the
#: ``*_rows`` launchers take per-row moduli (tables and a row index)
KERNELS = {
    "mulmod": ("mulmod", "mulmod_launch",
               (_P, _L, _P, _L, _P, _I, _I, _P, _P, _I, _I, _I, _I, _I, _P)),
    # the per-row product: operands, the modulus table (m, mu or R^2 mod
    # m, mp, row index), width, body; tpi, words, threads, blocks
    "mulmod_rows": ("mulmod", "mulmod_rows_launch",
                    (_P, _L, _P, _L, _P, _I, _I, _P, _P, _P, _P, _I, _I, _I,
                     _I, _I, _I, _P)),
    "modexp": ("modexp", "modexp_launch",
               (_P, _P, _P, _I, _I, _I, _P, _P, _P, _U, _I, _I, _I, *_GEOM,
                _P)),
    "modexp_rows": ("modexp", "modexp_rows_launch",
                    (_P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I,
                     *_GEOM, _P)),
    "modexp_fixed": ("modexp_fixed", "modexp_fixed_launch",
                     (_P, _P, _I, _I, _I, _I, *_HALF, *_HALF, _I, _I, *_GEOM,
                      _P)),
    # the product tree: factors with row and factor strides, the modulus
    # table (m, R mod m or mu, R^N mod m, mp, row index), width, body;
    # tpi, words, groups a row, threads, blocks, shared memory
    "prod_rows": ("prodtree", "prod_rows_launch",
                  (_P, _L, _L, _P, _I, _I, _I, _P, _P, _P, _P, _P, _I, _I,
                   _I, _I, _I, _I, _I, _I, _P)),
}

#: launches per kernel body (``geometry.BODIES``), and per (body, batch,
#: width in words), bumped by the wrappers; reset with reset_launches()
LAUNCHES = dict.fromkeys(geometry.BODIES, 0)
SHAPE_LAUNCHES: collections.Counter = collections.Counter()

_FUNCS: dict = {}
_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()   # a split batch launches from a thread a card


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    SHAPE_LAUNCHES.clear()


def count_launch(body: str, B: int, k: int) -> None:
    """One launch of ``body`` over B integers of k words."""
    with _COUNT_LOCK:
        LAUNCHES[body] += 1
        SHAPE_LAUNCHES[(body, B, k)] += 1


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    return str(Path(home) / "bin" / "nvcc")


def library_path(name: str) -> Path:
    """Cache path of the library of source ``name``: a hash of the flags
    and sources
    (``-Xptxas -v`` changes only the compiler's report, not the code)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(ptxas_verbose: bool = False,
              rebuild: bool = False) -> dict[str, str]:
    """Compile every source whose library is missing (every source with
    ``rebuild``), in parallel.

    Returns each compiled source's compiler output (with
    ``ptxas_verbose``, the registers, stack and spills per instantiation);
    raises with the output of every ``nvcc`` that failed.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in SOURCES:
        out = library_path(name)
        if out.exists() and not rebuild:
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        verbose = ("-Xptxas", "-v") if ptxas_verbose else ()
        cmd = [nvcc, *NVCC_FLAGS, *verbose, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, errors = {}, []
    for name, (proc, tmp, out) in procs.items():
        try:
            logs[name], _ = proc.communicate(timeout=NVCC_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            logs[name], _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            errors.append(f"nvcc {name}.cu (exit {proc.returncode}):\n"
                          f"{logs[name]}")
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return logs


def launcher(name: str):
    """The C launch function ``name`` (a key of :data:`KERNELS`),
    building the libraries if needed."""
    fn = _FUNCS.get(name)
    if fn is not None:
        return fn
    with _LOCK:
        if name not in _FUNCS:
            with trace.span("kernels.build"):
                t0 = time.perf_counter()
                built = build_all()
                from ..obs.metrics import record_profile
                record_profile("kernel_build", kernels=sorted(built),
                               seconds=time.perf_counter() - t0)
                libs = {src: ctypes.CDLL(str(library_path(src)))
                        for src in SOURCES}
                for kname, (src, sym, argtypes) in KERNELS.items():
                    fn = getattr(libs[src], sym)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                    _FUNCS[kname] = fn
    return _FUNCS[name]


def require_rows(name: str, x, rows: int, cols: int) -> None:
    """Raise unless ``x`` is a CUDA tensor of shape (rows, cols): the
    kernels index their operands from these sizes."""
    if x.device.type != "cuda" or tuple(x.shape) != (rows, cols):
        raise ValueError(f"{name}: expected a CUDA tensor of shape "
                         f"({rows}, {cols}), got {tuple(x.shape)} on "
                         f"{x.device}")


def require_index(name: str, rm, rows: int, device) -> "torch.Tensor":
    """The row index of a :class:`~repro_torch.kernels.common.RowsModulus`
    as the ``*_rows`` kernels read it: (rows,) contiguous int32 on
    ``device``, every entry a row of its table, and the table's kernel
    tensors on the same device.  Raises otherwise: the kernels read table
    rows at these indices unchecked.  The entries are checked against the
    range the index was built with (``common.index_range``), so nothing
    here reads the index back or waits for the device."""
    import torch
    from .common import index_range
    midx, dm = rm.midx, rm.table
    if midx.dtype != torch.int32 or tuple(midx.shape) != (rows,) \
            or midx.device != device or not midx.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous ({rows},) int32 "
                         f"row index on {device}, got {midx.dtype} "
                         f"{tuple(midx.shape)} on {midx.device}")
    T = len(rm.moduli)
    W = 2 * dm.L32
    want = {"mw": (T, W), "muw": (T, W + 2)}
    if dm.mp is not None:             # Montgomery material
        want.update(mp=(T,), r1=(T, W), r2=(T, W))
    for field, shape in want.items():
        x = getattr(dm, field)
        if tuple(x.shape) != shape or x.device != device:
            raise ValueError(f"{name}: modulus table of {T} rows does not "
                             f"match its kernel tensor {field} "
                             f"{tuple(x.shape)} on {x.device}")
    try:
        span = index_range(midx)
    except ValueError as err:
        raise ValueError(f"{name}: {err}") from None
    if span is not None and not 0 <= span[0] <= span[1] < T:
        raise ValueError(f"{name}: row index outside the table's {T} rows")
    return midx


def check(rc: int, name: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
