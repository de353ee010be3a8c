"""Batched-hypothesis RANSAC for the essential matrix.

CUDA RANSAC loops sequentially until a confidence bound; here the idiomatic
shape is *all hypotheses at once*: sample K minimal sets, solve K eigenvalue
problems in one batch, score the K x N Sampson-error matrix in one pass, then
argmax inliers.  K is static; with K = 512 the success probability at 50%
inliers exceeds 1 - (1 - 0.5^8)^512 ~ 0.87, and two refit (IRLS) passes on
the winning inlier set recover the rest.  Everything is one jitted program
with no host round trips.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .epipolar import essential_from_eight, recover_pose, sampson_error
from .se3 import highest_precision


class RansacResult(NamedTuple):
    E: jax.Array          # [3, 3] best essential matrix
    R: jax.Array          # [3, 3] recovered rotation (X2 = R X1 + t)
    t: jax.Array          # [3] unit translation
    inliers: jax.Array    # [N] bool
    num_inliers: jax.Array  # scalar int32


def _sample_minimal_sets(key, mask, num_hyps: int, sample_size: int):
    """[K, S] indices drawn (with replacement across sets) from valid rows.

    Replacement-free sampling inside one set matters little at these N; we
    instead draw S independent picks per set and rely on the eigh solver
    tolerating occasional duplicates (rank drop -> degenerate E -> scored
    out).  Gumbel-top-k would also work but costs a [K, N] sort.
    """
    n = mask.shape[0]
    logits = jnp.where(mask, 0.0, -1e9)
    picks = jax.random.categorical(
        key, logits[None, None, :], axis=-1,
        shape=(num_hyps, sample_size))
    return picks


@partial(jax.jit, static_argnames=("num_hyps", "refit_iters"))
@highest_precision
def ransac_essential(key, x1, x2, valid, threshold: float = 1e-4,
                     num_hyps: int = 512, refit_iters: int = 2
                     ) -> RansacResult:
    """Estimate E (and pose) from putative matches with RANSAC + IRLS refit.

    Args:
      key: PRNG key.
      x1, x2: [N, 2] matched *normalized* coordinates.
      valid: [N] bool putative-match validity.
      threshold: Sampson-error inlier threshold (normalized-coord units^2;
        1e-4 ~ (1 px / f=1000)^2 * 100 — tune per camera).
      num_hyps: static number of parallel minimal sets.
      refit_iters: weighted refits on the winning inlier set.
    """
    idx = _sample_minimal_sets(key, valid, num_hyps, 8)   # [K, 8]
    s1 = x1[idx]  # [K, 8, 2]
    s2 = x2[idx]
    Es = essential_from_eight(s1, s2)                     # [K, 3, 3]
    err = sampson_error(Es, x1[None], x2[None])           # [K, N]
    inl = (err < threshold) & valid[None]
    counts = jnp.sum(inl.astype(jnp.int32), axis=1)
    best = jnp.argmax(counts)
    E = Es[best]

    # IRLS refit on the inlier set (weighted N-point re-estimation)
    def refit(E, _):
        err = sampson_error(E, x1, x2)
        w = ((err < threshold) & valid).astype(x1.dtype)
        E2 = essential_from_eight(x1, x2, weights=w)
        # keep the refit only if it does not lose inliers
        c_new = jnp.sum((sampson_error(E2, x1, x2) < threshold) & valid)
        c_old = jnp.sum((err < threshold) & valid)
        return jnp.where(c_new >= c_old, E2, E), None

    E, _ = jax.lax.scan(refit, E, None, length=refit_iters)

    final_err = sampson_error(E, x1, x2)
    inliers = (final_err < threshold) & valid
    R, t, cheir = recover_pose(E, x1, x2, inliers)
    return RansacResult(E=E, R=R, t=t, inliers=inliers & cheir,
                        num_inliers=jnp.sum((inliers & cheir).astype(
                            jnp.int32)))


def normalize_points(x_px, fx, fy, cx, cy):
    """Pixel -> normalized camera coordinates (K^-1 x)."""
    return jnp.stack([(x_px[..., 0] - cx) / fx,
                      (x_px[..., 1] - cy) / fy], axis=-1)
