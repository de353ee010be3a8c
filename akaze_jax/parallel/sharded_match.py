"""Descriptor matching sharded across a device mesh.

Replaces the reference's single-GPU brute-force matcher (gHammingMatch,
akazed.cu:2144-2241) at scale: query descriptors are sharded over the
``data`` axis, train descriptors are all-gathered between the cards
(NVLink), and each shard matches its queries on its own card.  For N
devices this gives an N-fold speedup of the O(N1*N2) matching while moving
only the (much smaller) descriptor tensors.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..match import Matches, match
from .mesh import normalize_axes


def compact_train(words, valid, x, y):
    """Re-compact a train set to a valid-prefix layout.

    A gathered multi-source set (per-shard prefixes concatenated by
    ``all_gather``) leaves dead slots between the shard prefixes; the
    matcher kernel bounds its scan by the LAST live row (match.py), so
    those holes are scanned at full cost — up to shard_count x the live
    work.  One nonzero-compaction (the spatial tier's _gather_features
    pattern) restores the valid-prefix invariant so the scan extent equals
    the live count again.

    Returns (words, valid, x, y, sel): compacted tensors of the same
    capacity plus the source-index map (``sel[k]`` = original row of
    compacted row k), for mapping match indices back to gathered order.
    """
    n = valid.shape[0]
    count = jnp.sum(valid.astype(jnp.int32))
    (sel,) = jnp.nonzero(valid, size=n, fill_value=0)
    live = jnp.arange(n, dtype=jnp.int32) < count
    return (jnp.where(live[:, None], words[sel], 0), live,
            x[sel], y[sel], sel)


def sharded_match(words1, valid1, words2, valid2, x2, y2, mesh: Mesh,
                  max_dist: int = 96, axis="data",
                  use_pallas: str = "auto") -> Matches:
    """1-NN Hamming matching with queries sharded over ``axis``.

    words2/valid2/x2/y2 may be sharded too — they are all-gathered inside,
    then prefix-compacted so matcher work scales with
    the live descriptor count rather than the slot capacity.  Returned
    match indices refer to the gathered (shard-major slot) order.
    ``axis`` may be one axis name or an innermost-first hierarchy like
    ``("chip", "host")``.  ``use_pallas``: the matcher route
    (match.kernel_route).
    """
    axis = normalize_axes(axis)

    # check_vma=False: the matcher kernel's pallas_call declares no
    # varying-mesh-axes types for its outputs
    @partial(shard_map, mesh=mesh,
             in_specs=(P(axis), P(axis), P(axis), P(axis), P(axis), P(axis)),
             out_specs=P(axis), check_vma=False)
    def go(w1, v1, w2, v2, xx2, yy2):
        w2g = jax.lax.all_gather(w2, axis, axis=0, tiled=True)
        v2g = jax.lax.all_gather(v2, axis, axis=0, tiled=True)
        x2g = jax.lax.all_gather(xx2, axis, axis=0, tiled=True)
        y2g = jax.lax.all_gather(yy2, axis, axis=0, tiled=True)
        w2c, v2c, x2c, y2c, sel = compact_train(w2g, v2g, x2g, y2g)
        m = match(w1, v1, w2c, v2c, x2c, y2c, max_dist, use_pallas)
        # compacted row -> gathered slot, so callers can index the
        # gathered train tensors with Matches.index as before
        idx = jnp.where(m.index >= 0,
                        sel[jnp.clip(m.index, 0)].astype(jnp.int32), -1)
        return Matches(index=idx, distance=m.distance,
                       match_x=m.match_x, match_y=m.match_y)

    return go(words1, valid1, words2, valid2, x2, y2)
