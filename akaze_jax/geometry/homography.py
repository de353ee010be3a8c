"""Batched homography estimation + RANSAC, and DLT PnP absolute pose.

Same batched shape as ransac.py: all hypotheses solved in one batched
eigen-problem, scored as one [K, N] error matrix, refined by IRLS.

Conventions: x2 ~ H x1 (homogeneous); PnP solves world points X -> pixel-
normalized observations u with X_cam = R X + t.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .ransac import _sample_minimal_sets
from .se3 import highest_precision


def _homog(x):
    return jnp.concatenate([x, jnp.ones_like(x[..., :1])], axis=-1)


def _hartley(x, weights=None):
    """Similarity transform T (and T x) bringing points to zero mean and
    sqrt(2) RMS radius — unnormalized float32 DLT loses the smallest
    eigenvector entirely at pixel scales."""
    if weights is None:
        w = jnp.ones_like(x[..., 0])
    else:
        w = weights
    wsum = jnp.maximum(jnp.sum(w, axis=-1, keepdims=True), 1e-6)
    mean = jnp.sum(x * w[..., None], axis=-2,
                   keepdims=True) / wsum[..., None]
    d = jnp.sqrt(jnp.sum((x - mean) ** 2, axis=-1))
    rms = jnp.sqrt(jnp.sum(d * d * w, axis=-1, keepdims=True)
                   / wsum) + 1e-12
    sc = jnp.sqrt(2.0) / rms                        # [..., 1]
    xn = (x - mean) * sc[..., None]
    # T = [[s, 0, -s*mx], [0, s, -s*my], [0, 0, 1]]
    batch = x.shape[:-2]
    T = jnp.zeros(batch + (3, 3), x.dtype)
    T = T.at[..., 0, 0].set(sc[..., 0]).at[..., 1, 1].set(sc[..., 0])
    T = T.at[..., 0, 2].set(-sc[..., 0] * mean[..., 0, 0])
    T = T.at[..., 1, 2].set(-sc[..., 0] * mean[..., 0, 1])
    T = T.at[..., 2, 2].set(1.0)
    return xn, T


def homography_from_points(x1, x2, weights=None):
    """Batched DLT homography (4+ correspondences), Hartley-normalized.

    Args: x1, x2 [..., N, 2]; weights optional [..., N].
    Returns H [..., 3, 3].
    """
    x1, T1 = _hartley(x1, weights)
    x2, T2 = _hartley(x2, weights)
    h1 = _homog(x1)                                # [..., N, 3]
    zeros = jnp.zeros_like(h1)
    u = x2[..., 0:1]
    v = x2[..., 1:2]
    # standard 2-rows-per-point DLT system A h = 0
    row1 = jnp.concatenate([zeros, -h1, v * h1], axis=-1)   # [..., N, 9]
    row2 = jnp.concatenate([h1, zeros, -u * h1], axis=-1)
    A = jnp.concatenate([row1, row2], axis=-2)              # [..., 2N, 9]
    if weights is not None:
        w2 = jnp.concatenate([weights, weights], axis=-1)
        A = A * w2[..., None]
    AtA = jnp.swapaxes(A, -1, -2) @ A
    evals, evecs = jnp.linalg.eigh(AtA)
    h = evecs[..., :, 0]
    Hn = h.reshape(h.shape[:-1] + (3, 3))
    # denormalize: H = T2^-1 Hn T1
    H = jnp.linalg.solve(T2, Hn @ T1)
    return H


def homography_transfer_error(H, x1, x2):
    """Symmetric-free forward transfer error |H x1 - x2|^2, [..., N]."""
    h1 = _homog(x1)
    p = h1 @ jnp.swapaxes(H, -1, -2)               # [..., N, 3]
    z = jnp.where(jnp.abs(p[..., 2:3]) < 1e-12, 1e-12, p[..., 2:3])
    d = p[..., :2] / z - x2
    return jnp.sum(d * d, axis=-1)


class HomographyResult(NamedTuple):
    H: jax.Array           # [3, 3]
    inliers: jax.Array     # [N] bool
    num_inliers: jax.Array


@partial(jax.jit, static_argnames=("num_hyps", "refit_iters"))
@highest_precision
def ransac_homography(key, x1, x2, valid, threshold: float = 9.0,
                      num_hyps: int = 512, refit_iters: int = 2
                      ) -> HomographyResult:
    """RANSAC homography over putative matches (pixel or normalized coords;
    ``threshold`` is squared transfer error in the same units)."""
    idx = _sample_minimal_sets(key, valid, num_hyps, 4)
    Hs = homography_from_points(x1[idx], x2[idx])           # [K, 3, 3]
    err = homography_transfer_error(Hs, x1[None], x2[None])  # [K, N]
    inl = (err < threshold) & valid[None]
    counts = jnp.sum(inl.astype(jnp.int32), axis=1)
    H = Hs[jnp.argmax(counts)]

    def refit(H, _):
        e = homography_transfer_error(H, x1, x2)
        w = ((e < threshold) & valid).astype(x1.dtype)
        H2 = homography_from_points(x1, x2, weights=w)
        c_new = jnp.sum((homography_transfer_error(H2, x1, x2) < threshold)
                        & valid)
        c_old = jnp.sum((e < threshold) & valid)
        return jnp.where(c_new >= c_old, H2, H), None

    H, _ = jax.lax.scan(refit, H, None, length=refit_iters)
    final = homography_transfer_error(H, x1, x2)
    inliers = (final < threshold) & valid
    return HomographyResult(H=H, inliers=inliers,
                            num_inliers=jnp.sum(inliers.astype(jnp.int32)))


def pnp_dlt(X, u, weights=None):
    """DLT absolute pose from 6+ world<->normalized-image correspondences.

    Args: X [N, 3] world points; u [N, 2] normalized camera coords;
    weights optional [N].
    Returns (R [3, 3], t [3]) with X_cam = R X + t (cheirality-corrected
    sign, orthonormalized rotation).
    """
    n = X.shape[0]
    Xh = jnp.concatenate([X, jnp.ones((n, 1), X.dtype)], axis=1)  # [N, 4]
    zeros = jnp.zeros_like(Xh)
    row1 = jnp.concatenate([Xh, zeros, -u[:, 0:1] * Xh], axis=1)  # [N, 12]
    row2 = jnp.concatenate([zeros, Xh, -u[:, 1:2] * Xh], axis=1)
    A = jnp.concatenate([row1, row2], axis=0)                     # [2N, 12]
    if weights is not None:
        w2 = jnp.concatenate([weights, weights], axis=0)
        A = A * w2[:, None]
    AtA = A.T @ A
    evals, evecs = jnp.linalg.eigh(AtA)
    p = evecs[:, 0].reshape(3, 4)
    # P is defined up to scale AND sign; visible points need positive
    # depth, so fix the sign by the depth majority first
    z = X @ p[:, :3].T + p[:, 3]
    sgn = jnp.where(jnp.sum(jnp.sign(z[:, 2])) < 0, -1.0, 1.0)
    p = p * sgn
    M = p[:, :3]
    # for a clean projection M = s R with s > 0, so det(M) = s^3 > 0
    scale = jnp.cbrt(jnp.maximum(jnp.linalg.det(M), 1e-12))
    M = M / scale
    tv = p[:, 3] / scale
    # nearest proper rotation
    U, s, Vt = jnp.linalg.svd(M)
    D = jnp.diag(jnp.asarray([1.0, 1.0, jnp.linalg.det(U @ Vt)]))
    R = U @ D @ Vt
    return R, tv
