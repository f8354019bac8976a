"""The kernels' build cache, behind the reference's compile-cache surface.

``repro.kernels.compile_cache`` points JAX's persistent compilation cache
at a directory so a second process deserializes its executables instead
of lowering them again.  The port has no JIT to cache: its kernels are
``nvcc``-built shared libraries that ``kernels/build.py`` keeps under
``build/repro_torch/`` at the repository root, named by a hash of the
sources and flags, so a later process always loads them without
rebuilding.  This module keeps the reference's :func:`enable` /
:func:`stats` surface over that directory (the RunReport's
``runtime.compile_cache`` section); the JAX cache knobs have no
counterpart and nothing here can switch the build cache off.
"""
from __future__ import annotations

from . import build


def cache_dir() -> str:
    return str(build.BUILD_DIR)


def enable() -> str:
    """The build-cache directory in use (the cache is always on)."""
    return cache_dir()


def stats() -> dict:
    """``{"enabled", "dir", "entries"}``: the built kernel libraries on
    disk (every source/flag hash built so far, this process's included)."""
    entries = sum(1 for p in build.BUILD_DIR.glob("*.so")
                  if ".tmp." not in p.name) \
        if build.BUILD_DIR.is_dir() else 0
    return {"enabled": True, "dir": cache_dir(), "entries": entries}
