"""The warm-up cache: a shared kernel-build directory, and compile counting.

The counterpart of `sparknet_tpu/utils/compile_cache.py`. An eager
PyTorch process compiles no graph and this port captures no CUDA graph:
the one thing it compiles is its kernels (`ops/_build.py` runs nvcc once
per `csrc/*.cu` into a hash-named library). So the JAX module's names
mean, in the port:

  JAX package                              port
  one fresh XLA backend compile            one nvcc run (`builds`)
    (`xla_compiles`)
  persistent-cache hit                     the library was already on disk
                                           in the build directory
  persistent-cache miss                    nvcc ran
  `jax_compilation_cache_dir`              the kernel build directory
                                           (`sparknet_tpu_torch/_build/`
                                           when none is configured)

  - `init_compile_cache(dir)` points the kernel builds at a directory that
    several processes (a replica fleet) or machines share. Resolves, in
    order: the explicit argument, `$SPARKNET_COMPILE_CACHE`; with
    neither, the default `_build/` stays and it returns None. The first
    caller wins, as in the JAX package. The directory is made if missing;
    a directory that cannot be made raises.

  - `track_compiles()` counts the nvcc runs and the libraries found on or
    missing from disk INSIDE the region, on this thread. `.builds` is the
    JAX module's `.xla_compiles`. `obs.device.timed_compile` and the serve
    bucket's first forward stamp the verdict `.cache_hit` as the
    `cache_hit` label of `sparknet_compile_events_total`: True exactly when
    the region ran no fresh compilation (no nvcc), as the JAX package
    defines it. "Zero cache_hit=false events on a warm replica cold
    start" reads the same in both packages.

`ops/_build.py` counts per thread on the thread that calls `load` /
`build_all`, which is the thread whose forward first launches a kernel
(the serve lane's worker, the trainer's main thread). The JAX module's
`ensure_listeners` registers `jax.monitoring` listeners; the port has
nothing to listen to, and has no such function.

Known difference (ROADMAP C): the default `_build/` is itself persistent,
so a region on a machine whose libraries are built, or on the CPU, where
nothing is built, reads as a hit with no directory configured, where the
JAX package counts a cold XLA compile as a miss.
"""
from __future__ import annotations

import os
import threading
from typing import Optional

from ..ops import _build

_lock = threading.Lock()
_cache_dir: Optional[str] = None


def init_compile_cache(cache_dir: Optional[str] = None) -> Optional[str]:
    """Point the kernel builds at the warm-up cache directory (idempotent:
    the train loop, the serve CLI and tests may all call it). Returns the
    active directory, or None when none is configured and the default
    `_build/` stays."""
    global _cache_dir
    d = cache_dir or os.environ.get("SPARKNET_COMPILE_CACHE") or None
    if not d:
        return _cache_dir
    d = os.path.abspath(os.path.expanduser(str(d)))
    with _lock:
        if _cache_dir is not None:
            # FIRST caller wins: the build directory is process-global, and
            # repointing it mid-flight would split one process's kernels
            # over two caches (reset_for_tests() exists for tests that need
            # a fresh directory)
            return _cache_dir
        os.makedirs(d, exist_ok=True)
        _build.relocate(d)
        _cache_dir = d
    return d


def cache_dir() -> Optional[str]:
    """The active warm-up cache directory (None = not initialized)."""
    return _cache_dir


def is_initialized() -> bool:
    return _cache_dir is not None


class track_compiles:
    """Context manager: counts this THREAD's nvcc runs and the kernel
    libraries it found on or missing from disk inside the region.

    After exit: `.builds` (the JAX module's `.xla_compiles`),
    `.cache_hits`, `.cache_misses`, and the verdict `.cache_hit`: True iff
    the region ran no nvcc."""

    builds = 0
    cache_hits = 0
    cache_misses = 0

    def __enter__(self) -> "track_compiles":
        c = _build.counts()
        self._t0 = (c["build"], c["hit"], c["miss"])
        return self

    def __exit__(self, *exc) -> bool:
        c = _build.counts()
        self.builds = c["build"] - self._t0[0]
        self.cache_hits = c["hit"] - self._t0[1]
        self.cache_misses = c["miss"] - self._t0[2]
        return False

    @property
    def cache_hit(self) -> bool:
        if self.builds == 0:
            return True  # nothing was compiled fresh
        # fresh work ran: a hit would need the cache consulted with no
        # miss, which a region that ran nvcc never has (the JAX rule)
        return (self.cache_misses == 0
                and self.cache_hits + self.cache_misses > 0)


def reset_for_tests() -> None:
    """Clear the active-directory latch and build into the default
    `_build/` again, so tests can re-init against their own tmp dirs.
    Libraries already loaded stay loaded."""
    global _cache_dir
    with _lock:
        _cache_dir = None
        _build.relocate(_build.DEFAULT_BUILD_DIR)
