"""The port's persistent compile cache and its hit / miss counts
(counterpart of paddle_tpu/framework/compile_cache.py).

The JAX package points jax's persistent compilation cache at a directory
and counts its lookups. The port compiles nothing through a framework: its
only compiled programs are the CUDA kernels that `_build.py` builds with
nvcc into its build directory at first use, and that directory is the
port's persistent cache. So here:

- a miss is an nvcc run (no up-to-date library for the source and flags);
- a hit is an up-to-date `.so` found in the build directory and loaded.

`ServingGateway.rollout()`'s `cache_hits` / `cache_misses` keep their
meaning, "did the new version's bring-up compile anything". The serving
engines launch no kernel (their attention is always masked), so a warm
bring-up in the port reads 0 / 0 where the JAX package reads its XLA cache
hits.

`configure(path)` points the builds at another directory (default: the
package's `_build/`). The compiled programs of `jit.to_static` and the
inference `Predictor` are Inductor's; `configure_inductor(path)` points
Inductor's own cache (its FX graphs and generated kernels) at a directory,
where `Config.set_optim_cache_dir` asks for it. Not ported: ``disable()`` /
``enabled()`` (nvcc builds are always cached) and the per-thread tallies
the reference's compile watchdog reads: the port's watchdog reads
Inductor's FX-graph-cache counters instead (monitor/perf/watchdog.py).
"""
import threading

import os

__all__ = ['configure', 'configure_inductor', 'stats', 'hit_rate',
           'reset_stats']

_lock = threading.Lock()
_hits = 0
_misses = 0


def configure(path=None):
    """Point the kernel builds at `path` (the package's `_build/` when
    None); returns the effective directory. The last caller wins."""
    from .. import _build
    path = path or _build.DEFAULT_BUILD_DIR
    _build.BUILD_DIR = path
    return path


def configure_inductor(path):
    """Point Inductor's cache at `path` (read by every later compile in
    this process and in the processes it starts); returns the absolute
    path. The last caller wins."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    os.environ['TORCHINDUCTOR_CACHE_DIR'] = path
    return path


def note(hit):
    """Count one lookup of a kernel library (`_build.py` calls this):
    hit=True for an up-to-date library, False for an nvcc run."""
    global _hits, _misses
    with _lock:
        if hit:
            _hits += 1
        else:
            _misses += 1


def stats():
    """Process-wide {'hits', 'misses'} since import (or reset_stats)."""
    with _lock:
        return {'hits': _hits, 'misses': _misses}


def hit_rate():
    """hits / (hits + misses), or None before any lookup."""
    with _lock:
        total = _hits + _misses
        return (_hits / total) if total else None


def reset_stats():
    """Zero the global tallies (tests)."""
    global _hits, _misses
    with _lock:
        _hits = 0
        _misses = 0
