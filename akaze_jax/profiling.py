"""Timing and compile-cache helpers.

A device time is the host clock around a call that ends in
``jax.block_until_ready``, after warm-up calls have compiled the program:
JAX returns before the device finishes, so a timing without the block
measures only the enqueue.  Any process on the card uses that one card
only; compare two versions in one process, on one card, in turns.
"""

from __future__ import annotations

import os
import statistics
import time

import jax

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def enable_compile_cache():
    """Persistent compilation cache.  Where ``JAX_COMPILATION_CACHE_DIR``
    is set, JAX already uses that directory and nothing is set here;
    otherwise the cache lives in ``<checkout>/.jax_cache``."""
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir",
                          os.path.join(REPO_ROOT, ".jax_cache"))


def time_call(fn, *args, warmup: int = 2, iters: int = 10) -> float:
    """Median seconds of ``fn(*args)`` (jitted here) over ``iters`` calls,
    each ended by ``block_until_ready``, after ``warmup`` untimed calls."""
    f = jax.jit(fn)
    for _ in range(warmup):
        jax.block_until_ready(f(*args))
    times = []
    for _ in range(iters):
        t = time.perf_counter()
        jax.block_until_ready(f(*args))
        times.append(time.perf_counter() - t)
    return statistics.median(times)

