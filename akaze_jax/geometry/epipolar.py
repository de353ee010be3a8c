"""Two-view epipolar geometry, batched.

Essential-matrix estimation uses the normalized 8-point algorithm: the
nullspace of the constraint matrix A is its last right singular vector, from
a batched 9x9 SVD (tall A is first reduced to its 9x9 QR factor R, which has
the same right singular vectors).  The essential-manifold projection and pose
decomposition use small 3x3 SVDs.

Conventions: points are *normalized camera coordinates* (pixel coords
premultiplied by K^-1), x2^T E x1 = 0, and the recovered pose (R, t) maps
points from camera-1 frame to camera-2 frame: X2 = R X1 + t.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .se3 import hat


def _homog(x):
    return jnp.concatenate([x, jnp.ones_like(x[..., :1])], axis=-1)


def essential_from_eight(x1, x2, weights=None):
    """Batched 8-point (or weighted N-point) essential matrix.

    Args:
      x1, x2: [..., N, 2] normalized coords in image 1 / image 2 (N >= 8).
      weights: optional [..., N] nonneg weights (soft inlier masks for IRLS).

    Returns:
      E: [..., 3, 3] with the essential constraint (two equal singular
      values, one zero) enforced.
    """
    h1 = _homog(x1)  # [..., N, 3]
    h2 = _homog(x2)
    # constraint rows: kron(h1, h2) so that row . vec(E) = h2^T E h1
    A = (h2[..., :, :, None] * h1[..., :, None, :]).reshape(
        x1.shape[:-1] + (9,))
    if weights is not None:
        A = A * weights[..., None]
    # the smallest eigenvector of A^T A would square A's condition number:
    # in f32 that left the null vector to the eigensolver's rounding, and
    # LAPACK and cuSOLVER then chose different RANSAC hypotheses
    if A.shape[-2] > 9:
        A = jnp.linalg.qr(A, mode="r")                     # [..., 9, 9]
    elif A.shape[-2] < 9:
        A = jnp.concatenate([A, jnp.zeros(
            A.shape[:-2] + (9 - A.shape[-2], 9), A.dtype)], axis=-2)
    e = jnp.linalg.svd(A)[2][..., -1, :]  # smallest singular value's vector
    E = e.reshape(e.shape[:-1] + (3, 3))
    # project to the essential manifold: singular values -> (1, 1, 0)
    U, s, Vt = jnp.linalg.svd(E)
    # keep det(U) = det(V) = +1 to make the downstream decomposition stable
    dU = jnp.linalg.det(U)[..., None, None]
    dV = jnp.linalg.det(Vt)[..., None, None]
    U = U * jnp.concatenate(
        [jnp.ones_like(dU), jnp.ones_like(dU), dU], axis=-1)
    Vt = Vt * jnp.concatenate(
        [jnp.ones_like(dV), jnp.ones_like(dV), dV], axis=-2)
    S = jnp.zeros_like(E).at[..., 0, 0].set(1.0).at[..., 1, 1].set(1.0)
    return U @ S @ Vt


def sampson_error(E, x1, x2):
    """First-order geometric (Sampson) error of x2^T E x1 = 0.

    Args: E [..., 3, 3]; x1, x2 [..., N, 2].  Returns [..., N].
    """
    h1 = _homog(x1)
    h2 = _homog(x2)
    Ex1 = h1 @ jnp.swapaxes(E, -1, -2)     # [..., N, 3] = (E @ h1^T)^T
    Etx2 = h2 @ E                           # [..., N, 3] = (E^T @ h2^T)^T
    num = jnp.sum(h2 * Ex1, axis=-1)
    den = (Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2
           + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2)
    return num * num / jnp.maximum(den, 1e-12)


def decompose_essential(E):
    """E -> the four (R, t) candidates [(R1,t), (R1,-t), (R2,t), (R2,-t)].

    Returns (Rs [..., 4, 3, 3], ts [..., 4, 3]) with |t| = 1.
    """
    U, s, Vt = jnp.linalg.svd(E)
    dU = jnp.linalg.det(U)[..., None, None]
    dV = jnp.linalg.det(Vt)[..., None, None]
    U = U * jnp.concatenate(
        [jnp.ones_like(dU), jnp.ones_like(dU), dU], axis=-1)
    Vt = Vt * jnp.concatenate(
        [jnp.ones_like(dV), jnp.ones_like(dV), dV], axis=-2)
    W = jnp.asarray([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                    E.dtype)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[..., :, 2]
    Rs = jnp.stack([R1, R1, R2, R2], axis=-3)
    ts = jnp.stack([t, -t, t, -t], axis=-2)
    return Rs, ts


def triangulate(R, t, x1, x2):
    """Midpoint-free linear (DLT) triangulation in camera-1 frame.

    Args: (R, t) camera-2 pose (X2 = R X1 + t); x1, x2 [..., N, 2].
    Returns X [..., N, 3] and depths (z1, z2) [..., N].
    """
    # rows of P1 = [I | 0], P2 = [R | t]
    h1 = _homog(x1)
    h2 = _homog(x2)
    # A X = b built from x1 ^ (P1 X) and x2 ^ (P2 X); use the 4 standard rows
    # row1: x1.x * P1[2] - P1[0], etc.  P1 = [I|0] simplifies rows 1-2.
    batch = x1.shape[:-1]

    Rb = jnp.broadcast_to(R[..., None, :, :], batch + (3, 3))
    tb = jnp.broadcast_to(t[..., None, :], batch + (3,))

    r0, r1, r2 = Rb[..., 0, :], Rb[..., 1, :], Rb[..., 2, :]
    t0, t1, t2 = tb[..., 0], tb[..., 1], tb[..., 2]

    e0 = jnp.zeros(batch + (3,), x1.dtype).at[..., 0].set(1.0)
    e1 = jnp.zeros(batch + (3,), x1.dtype).at[..., 1].set(1.0)
    e2 = jnp.zeros(batch + (3,), x1.dtype).at[..., 2].set(1.0)

    A = jnp.stack([
        x1[..., 0, None] * e2 - e0,
        x1[..., 1, None] * e2 - e1,
        x2[..., 0, None] * r2 - r0,
        x2[..., 1, None] * r2 - r1,
    ], axis=-2)  # [..., 4, 3]
    b = jnp.stack([
        jnp.zeros_like(t0), jnp.zeros_like(t0),
        t0 - x2[..., 0] * t2,
        t1 - x2[..., 1] * t2,
    ], axis=-1)  # [..., 4]

    AtA = jnp.swapaxes(A, -1, -2) @ A
    Atb = (jnp.swapaxes(A, -1, -2) @ b[..., None])[..., 0]
    # 3x3 solve with a ridge for degenerate rays
    AtA = AtA + 1e-9 * jnp.eye(3, dtype=x1.dtype)
    X = jnp.linalg.solve(AtA, Atb[..., None])[..., 0]
    z1 = X[..., 2]
    z2 = (Rb @ X[..., None])[..., 0][..., 2] + t2
    return X, z1, z2


def recover_pose(E, x1, x2, mask=None):
    """Choose the (R, t) candidate with the most points in front of both
    cameras (cheirality), like cv::recoverPose.

    Args: E [3, 3]; x1, x2 [N, 2]; mask optional [N] bool.
    Returns (R [3,3], t [3], good [N] bool front-of-both mask).
    """
    Rs, ts = decompose_essential(E)  # [4, 3, 3], [4, 3]
    if mask is None:
        mask = jnp.ones(x1.shape[0], bool)

    def count(R, t):
        X, z1, z2 = triangulate(R, t, x1, x2)
        ok = (z1 > 0) & (z2 > 0) & mask
        return jnp.sum(ok.astype(jnp.int32)), ok

    counts, oks = jax.vmap(count)(Rs, ts)
    best = jnp.argmax(counts)
    return Rs[best], ts[best], oks[best]
