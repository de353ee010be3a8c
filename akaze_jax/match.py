"""Brute-force Hamming matching as a matrix product.

The reference matcher (gHammingMatch, akazed.cu:2144-2241) runs one 16-thread
block per query descriptor, with 8x ``__popcll`` per candidate pair.  Here
the same computation is one matmul: unpack the 486 descriptor bits to a
+-1-valued vector padded with zeros to 512 lanes; then

    hamming(a, b) = (486 - <sa, sb>) / 2

exactly (products are in {-1, 0, 1}; f32 accumulation of <= 512 of them is
exact, bf16 operands with f32 accumulation).  The XLA path below builds the
full [N1, N2] distance matrix; the kernel of ops/pallas_match.py keeps a
running top-2 instead.

Acceptance: the reference keeps a match only if its distance is < MAX_DIST
(= 96) and the minimum is *strictly unique* (gHammingMatch compares the
global minimum against the 15 other per-lane minima, akazed.cu:2207-2231;
gMatch uses 1st < 2nd, akazed.cu:2106).  Both collapse to
``best < second_best`` up to a lane-aliasing artifact on exact ties, which we
resolve deterministically as ``best < second_best``.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .config import DESCRIPTOR_BITS, DESCRIPTOR_WORDS


class Matches(NamedTuple):
    """Per-query match results, mirroring the AkazePoint match fields
    (akaze_structures.h:33-39).  Rejected queries hold -1."""
    index: jax.Array      # [N1] int32 index into the train set
    distance: jax.Array   # [N1] float32 Hamming distance
    match_x: jax.Array    # [N1] float32 matched point x
    match_y: jax.Array    # [N1] float32 matched point y


def _signed_bits(words):
    """[N, 16] uint32 -> [N, 512] bf16 in {-1, 0, +1} (0 on the pad lanes)."""
    n = words.shape[0]
    shifts = jnp.arange(32, dtype=jnp.uint32)[None, None, :]
    bits = ((words[:, :, None] >> shifts) & jnp.uint32(1)).astype(jnp.float32)
    bits = bits.reshape(n, DESCRIPTOR_WORDS * 32)
    lane = jnp.arange(DESCRIPTOR_WORDS * 32)
    live = (lane < DESCRIPTOR_BITS).astype(jnp.float32)[None, :]
    return ((2.0 * bits - 1.0) * live).astype(jnp.bfloat16)


def hamming_distance_matrix(words1, words2):
    """Exact [N1, N2] Hamming distances (float32 integer values)."""
    s1 = _signed_bits(words1)
    s2 = _signed_bits(words2)
    dot = jax.lax.dot_general(
        s1, s2, dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32)
    return 0.5 * (DESCRIPTOR_BITS - dot)


def kernel_route(use_pallas: str = "auto") -> str:
    """Resolve the matcher route: 'kernel' (the compiled Triton kernel,
    ops/pallas_match.py), 'interpret' (the same kernel in the Pallas
    interpreter, for CPU tests) or 'xla' (the reference path below).

    'auto' picks the kernel when the program runs on a GPU (the default
    backend, or the device set by ``jax.default_device``) and XLA
    elsewhere; 'on' demands the kernel and raises off the GPU.  Neither
    falls back: a kernel that fails to compile on the card raises."""
    dev = jax.config.jax_default_device
    backend = (jax.default_backend() if dev is None
               else dev if isinstance(dev, str) else dev.platform)
    if use_pallas == "auto":
        return "kernel" if backend == "gpu" else "xla"
    if use_pallas == "on":
        if backend != "gpu":
            raise ValueError(f"use_pallas='on' needs a GPU backend, not "
                             f"{backend!r}; use 'interpret' or 'off'")
        return "kernel"
    if use_pallas == "interpret":
        return "interpret"
    if use_pallas == "off":
        return "xla"
    raise ValueError(f"use_pallas must be 'auto', 'on', 'interpret' or "
                     f"'off', not {use_pallas!r}")


def last_live(valid):
    """Index of the last live slot + 1 (0 when none is live)."""
    n = valid.shape[0]
    return jnp.max(jnp.where(valid, jnp.arange(1, n + 1, dtype=jnp.int32),
                             0))


def match(words1, valid1, words2, valid2, x2, y2,
          max_dist: int = 96, use_pallas: str = "auto") -> Matches:
    """1-NN Hamming match with strict-uniqueness acceptance.

    Args:
      words1/valid1: query descriptors [N1, 16] uint32 and validity [N1].
      words2/valid2/x2/y2: train descriptors, validity and coordinates.
      max_dist: acceptance threshold (MAX_DIST, akazed.cu:11).
      use_pallas: matcher route, see ``kernel_route``.  The kernel scans
        only up to the last live query and train rows and never writes the
        [N1, N2] distance matrix.  Both routes add 1e6 to the distance
        of an invalid train row, so they accept the same matches for any
        ``max_dist`` below 1e6.
    """
    route = kernel_route(use_pallas)
    if route != "xla":
        from .ops.pallas_match import hamming_top2
        # the kernel scans up to the LAST live row (+1), so work scales
        # with the live extent, not the slot capacity.  For the usual
        # prefix-compacted sets (detect.select_keypoints) this equals the
        # live count; for gathered multi-source train sets it still covers
        # every live row.
        best, second, bidx = hamming_top2(
            _signed_bits(words1), _signed_bits(words2), valid2,
            last_live(valid1), last_live(valid2),
            interpret=(route == "interpret"))
        bidx = jnp.clip(bidx, 0, words2.shape[0] - 1)
    else:
        d = hamming_distance_matrix(words1, words2)
        d = d + jnp.where(valid2[None, :], 0.0, 1.0e6)
        # min + masked second-min as plain reductions (lax.top_k over the
        # full [N1, N2] matrix is a per-row sort and dominates the runtime)
        best = jnp.min(d, axis=1)
        bidx = jnp.argmin(d, axis=1).astype(jnp.int32)
        cols = jax.lax.broadcasted_iota(jnp.int32, d.shape, 1)
        second = jnp.min(jnp.where(cols == bidx[:, None], 1.0e9, d), axis=1)
    accept = (best < second) & (best < max_dist) & valid1
    return Matches(
        index=jnp.where(accept, bidx, -1),
        distance=jnp.where(accept, best, -1.0),
        match_x=jnp.where(accept, x2[bidx], -1.0),
        match_y=jnp.where(accept, y2[bidx], -1.0))
