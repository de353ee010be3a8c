"""SO(3) / SE(3) Lie-group operations, batched and jit-friendly.

Poses are stored as (R, t) with R [..., 3, 3] rotation matrices and
t [..., 3] translations — dense tensors that broadcast and batch,
rather than an AoS pose struct.  All functions accept arbitrary leading batch
dimensions.

Numerics: exp/log use the standard Rodrigues forms with Taylor fallbacks near
theta = 0 so gradients stay finite (needed by the Gauss-Newton solvers in
slam/).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

_EPS = 1e-8


def hat(w):
    """[..., 3] -> [..., 3, 3] skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = jnp.zeros_like(wx)
    return jnp.stack([
        jnp.stack([z, -wz, wy], axis=-1),
        jnp.stack([wz, z, -wx], axis=-1),
        jnp.stack([-wy, wx, z], axis=-1),
    ], axis=-2)


def vee(W):
    """[..., 3, 3] -> [..., 3] inverse of hat."""
    return jnp.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], axis=-1)


def _safe_norm(w, eps=1e-12):
    """||w|| with a zero (not NaN) gradient at w = 0.

    ``jnp.linalg.norm`` has d||w||/dw = w/||w|| = 0/0 at the origin, and the
    NaN propagates through *both* branches of any downstream ``jnp.where``
    — which silently zeroed the Gauss-Newton gradients in the solvers.
    """
    n2 = jnp.sum(w * w, axis=-1)
    small = n2 < eps
    n = jnp.sqrt(jnp.where(small, 1.0, n2))
    return jnp.where(small, 0.0, n)


# Small-angle switch: below this the closed forms lose all float32 precision
# ((1 - cos x) underflows to 0 for x < ~3.5e-4, making sinc/cosc ratios inf),
# while the Taylor forms are already accurate to ~1e-10.  1e-2 leaves both
# branches good to <1e-9 relative.
_SMALL = 1e-2


def _sinc(x):
    """sin(x)/x with Taylor fallback."""
    small = jnp.abs(x) < _SMALL
    xs = jnp.where(small, 1.0, x)
    x2 = x * x
    return jnp.where(small, 1.0 - x2 / 6.0 + x2 * x2 / 120.0,
                     jnp.sin(xs) / xs)


def _cosc(x):
    """(1 - cos(x)) / x^2 with Taylor fallback."""
    small = jnp.abs(x) < _SMALL
    xs = jnp.where(small, 1.0, x)
    x2 = x * x
    return jnp.where(small, 0.5 - x2 / 24.0 + x2 * x2 / 720.0,
                     (1.0 - jnp.cos(xs)) / (xs * xs))


def so3_exp(w):
    """Rodrigues: [..., 3] axis-angle -> [..., 3, 3] rotation."""
    theta = _safe_norm(w)
    W = hat(w)
    W2 = W @ W
    a = _sinc(theta)[..., None, None]
    b = _cosc(theta)[..., None, None]
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + a * W + b * W2


def so3_log(R):
    """[..., 3, 3] rotation -> [..., 3] axis-angle.

    Three regimes with *input-guarded* branches (each branch only ever sees
    values it is numerically safe — and differentiable — on; a plain
    ``jnp.where`` of unguarded branches would leak NaN gradients from the
    untaken side):
      small:  log = w_skew * (1 + |w_skew|^2 / 6),  w_skew = vee(R - R^T)/2
      regular: log = w_skew * theta / sin(theta)
      near pi: axis from the symmetric part, magnitude theta
    """
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = jnp.clip((trace - 1.0) * 0.5, -1.0, 1.0)
    w_skew = vee(R - jnp.swapaxes(R, -1, -2)) * 0.5   # sin(theta) * axis
    n2 = jnp.sum(w_skew * w_skew, axis=-1)            # sin(theta)^2

    small = cos_t > 1.0 - 1e-4
    near_pi = cos_t < -1.0 + 1e-4
    regular = ~small & ~near_pi

    # regular branch: guard arccos/sqrt inputs so gradients stay finite
    cos_safe = jnp.where(regular, cos_t, 0.0)
    theta_r = jnp.arccos(cos_safe)
    sin_safe = jnp.sqrt(jnp.where(regular, jnp.maximum(n2, 1e-20), 1.0))
    w_reg = w_skew * (theta_r / sin_safe)[..., None]

    # small-angle branch: theta/sin(theta) = 1 + sin^2/6 + O(theta^4)
    w_small = w_skew * (1.0 + n2 / 6.0)[..., None]

    # near-pi branch: axis^2 from diag of the symmetric part
    theta_pi = jnp.arccos(jnp.where(near_pi, cos_t, 0.0))
    B = (R + jnp.swapaxes(R, -1, -2)) * 0.5 - jnp.eye(3, dtype=R.dtype)
    diag = jnp.stack([B[..., 0, 0], B[..., 1, 1], B[..., 2, 2]], axis=-1)
    one_m_cos = jnp.maximum(1.0 - cos_t, _EPS)[..., None]
    axis2 = jnp.maximum(diag / one_m_cos + 1.0, 0.0)
    axis = jnp.sqrt(jnp.where(near_pi[..., None], axis2, 1.0))
    sign = jnp.where(w_skew >= 0, 1.0, -1.0)  # sign from the skew part
    axis = axis * sign
    axis = axis / jnp.maximum(_safe_norm(axis)[..., None], _EPS)
    w_pi = axis * theta_pi[..., None]

    return jnp.where(small[..., None], w_small,
                     jnp.where(near_pi[..., None], w_pi, w_reg))


def se3_identity(batch_shape=(), dtype=jnp.float32):
    R = jnp.broadcast_to(jnp.eye(3, dtype=dtype), batch_shape + (3, 3))
    t = jnp.zeros(batch_shape + (3,), dtype)
    return R, t


def se3_exp(xi):
    """[..., 6] twist (v, w) -> (R [..., 3, 3], t [..., 3]).

    Convention: xi[..., :3] = translation part v, xi[..., 3:] = rotation w;
    t = V(w) v with the standard left-Jacobian V.
    """
    v, w = xi[..., :3], xi[..., 3:]
    theta = _safe_norm(w)
    W = hat(w)
    W2 = W @ W
    R = so3_exp(w)
    b = _cosc(theta)
    # c = (theta - sin theta) / theta^3, Taylor: 1/6 - theta^2/120
    small = theta < _SMALL
    ts = jnp.where(small, 1.0, theta)
    c = jnp.where(small, 1.0 / 6.0 - theta * theta / 120.0,
                  (ts - jnp.sin(ts)) / (ts ** 3))
    eye = jnp.broadcast_to(jnp.eye(3, dtype=xi.dtype), W.shape)
    V = eye + b[..., None, None] * W + c[..., None, None] * W2
    t = (V @ v[..., None])[..., 0]
    return R, t


def se3_log(R, t):
    """(R, t) -> [..., 6] twist (v, w)."""
    w = so3_log(R)
    theta = _safe_norm(w)
    W = hat(w)
    W2 = W @ W
    # V^-1 = I - W/2 + (1/theta^2)(1 - sinc/(2 cosc)) W^2
    small = theta < _SMALL
    ts = jnp.where(small, 1.0, theta)
    coef = jnp.where(
        small, 1.0 / 12.0 + theta * theta / 720.0,
        (1.0 - (_sinc(ts) / (2.0 * _cosc(ts)))) / (ts * ts))
    eye = jnp.broadcast_to(jnp.eye(3, dtype=R.dtype), W.shape)
    Vinv = eye - 0.5 * W + coef[..., None, None] * W2
    v = (Vinv @ t[..., None])[..., 0]
    return jnp.concatenate([v, w], axis=-1)


def se3_inverse(R, t):
    Rt = jnp.swapaxes(R, -1, -2)
    return Rt, -(Rt @ t[..., None])[..., 0]


def se3_compose(Ra, ta, Rb, tb):
    """(Ra, ta) * (Rb, tb): apply b first, then a."""
    return Ra @ Rb, (Ra @ tb[..., None])[..., 0] + ta


def se3_apply(R, t, p):
    """Transform points p [..., 3] by (R, t)."""
    return (R @ p[..., None])[..., 0] + t


def highest_precision(fn):
    """Trace ``fn`` with every f32 matrix product at ``Precision.HIGHEST``.

    On a GPU the default precision of an f32 product may be TF32 (a 10-bit
    mantissa); the back-end's solvers (RANSAC, triangulation, BA, PGO)
    moved measurably with it.  Applied under each jitted solver entry, so
    the choice is part of the traced program."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)
    return wrapped
