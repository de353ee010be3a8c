"""Sparse bundle adjustment with a matrix-free Schur complement.

Problem: C camera poses (R [C, 3, 3], t [C, 3], world->camera), P landmarks
X [P, 3], and M observations (cam [M], pt [M], uv [M, 2] in *normalized*
camera coordinates) with a validity weight w [M].

Classic sparse BA exploits the arrow structure of the normal matrix

    [ U   W ] [dc]   [ -bc ]          U: block-diag over cameras (6x6)
    [ W^T V ] [dp] = [ -bp ]          V: block-diag over points  (3x3)

by marginalising the points: (U - W V^-1 W^T) dc = -bc + W V^-1 bp, then
back-substituting dp.  The twist here is that the reduced camera matrix
S = U - W V^-1 W^T is never assembled: CG on S needs only

    S x = U x + lam x - W (V + lam)^-1 (W^T x)

and both W^T x (scatter by point) and W y (gather by camera) are
segment-sums over the observation list — exactly the shape XLA and
``shard_map`` handle well.  Sharding observations/points over a mesh makes
every segment-sum local followed by one ``psum`` of [C, 6]-sized vectors
(see parallel/sharded_ba.py); cameras stay replicated.

Jacobians are analytic (vmapped closed forms), residuals use the standard
pinhole projection r = Xc[:2]/Xc[2] - uv.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry.se3 import se3_exp, se3_compose, hat, highest_precision


class BAProblem(NamedTuple):
    """Statically shaped BA problem (pad unused observations with w = 0)."""
    cam: jax.Array    # [M] int32 camera index per observation
    pt: jax.Array     # [M] int32 point index per observation
    uv: jax.Array     # [M, 2] normalized image coords
    w: jax.Array      # [M] float32 observation weight (0 = padding)


def _project(R, t, X):
    """Xc = R X + t; returns (pred [..., 2], Xc)."""
    Xc = (R @ X[..., None])[..., 0] + t
    z = jnp.where(jnp.abs(Xc[..., 2:3]) < 1e-8, 1e-8, Xc[..., 2:3])
    return Xc[..., :2] / z, Xc


def ba_residuals(R, t, X, prob: BAProblem):
    """[M, 2] weighted reprojection residuals."""
    pred, _ = _project(R[prob.cam], t[prob.cam], X[prob.pt])
    return (pred - prob.uv) * prob.w[:, None]


def ba_cost(R, t, X, prob: BAProblem):
    r = ba_residuals(R, t, X, prob)
    return 0.5 * jnp.sum(r * r)


def _obs_jacobians(R, t, X, prob: BAProblem):
    """Closed-form per-observation Jacobians.

    Camera update is right-multiplicative: T <- T * exp([v, w]); for
    X' = R(exp(w_hat) X + v) + t ~ Xc + R v + R w_hat X the derivative of Xc
    wrt (v, w) is [R, -R [X]_x].  Point derivative is R.

    Returns (r [M, 2], Jc [M, 2, 6], Jp [M, 2, 3]).
    """
    Rc = R[prob.cam]
    tc = t[prob.cam]
    Xp = X[prob.pt]
    pred, Xc = _project(Rc, tc, Xp)
    r = (pred - prob.uv) * prob.w[:, None]

    x, y = Xc[..., 0], Xc[..., 1]
    z = jnp.where(jnp.abs(Xc[..., 2]) < 1e-8, 1e-8, Xc[..., 2])
    iz = 1.0 / z
    iz2 = iz * iz
    # d(pred)/d(Xc) [M, 2, 3]
    dproj = jnp.stack([
        jnp.stack([iz, jnp.zeros_like(iz), -x * iz2], axis=-1),
        jnp.stack([jnp.zeros_like(iz), iz, -y * iz2], axis=-1),
    ], axis=-2)
    dproj = dproj * prob.w[:, None, None]

    dXc_dv = Rc                                  # [M, 3, 3]
    dXc_dw = -Rc @ hat(Xp)                       # [M, 3, 3]
    Jc = jnp.concatenate([dproj @ dXc_dv, dproj @ dXc_dw], axis=-1)
    Jp = dproj @ Rc                              # [M, 2, 3]
    return r, Jc, Jp


def _schur_solve(r, Jc, Jp, prob: BAProblem, n_cams: int, n_pts: int,
                 lam, cg_iters: int, psum_axis=None, local_points=False):
    """One damped GN step via matrix-free Schur CG.

    Returns (dc [C, 6], dp [P, 3]).  When ``psum_axis`` is given, the
    observation-indexed arrays are assumed sharded and camera-side
    reductions are followed by a psum over that mesh axis.  Point-side
    reductions are psum'd too unless ``local_points``: with landmarks
    partitioned so each point's observations live on one shard
    (parallel/sharded_ba.py:partition_landmarks), V/bp/W^T x are exact
    locally and per-CG-iteration communication shrinks to one [C, 6] psum,
    independent of the landmark count.
    """
    def cam_reduce(v):
        return jax.lax.psum(v, psum_axis) if psum_axis else v

    def pt_reduce(v):
        return v if local_points else cam_reduce(v)

    cam, pt = prob.cam, prob.pt

    # block diagonals and gradient
    U = cam_reduce(jax.ops.segment_sum(
        jnp.einsum("mki,mkj->mij", Jc, Jc), cam, n_cams))   # [C, 6, 6]
    V = pt_reduce(jax.ops.segment_sum(
        jnp.einsum("mki,mkj->mij", Jp, Jp), pt, n_pts))      # [P, 3, 3]
    bc = cam_reduce(jax.ops.segment_sum(
        jnp.einsum("mki,mk->mi", Jc, r), cam, n_cams))       # [C, 6]
    bp = pt_reduce(jax.ops.segment_sum(
        jnp.einsum("mki,mk->mi", Jp, r), pt, n_pts))         # [P, 3]

    Vd = V + lam * jnp.eye(3, dtype=V.dtype)
    Vinv = jnp.linalg.inv(Vd)                                # [P, 3, 3]

    def W_T_x(x):
        """W^T x: [C, 6] -> [P, 3] via observations."""
        xc = x[cam]                                          # [M, 6]
        contrib = jnp.einsum("mki,mkj,mj->mi", Jp, Jc, xc)
        return pt_reduce(jax.ops.segment_sum(contrib, pt, n_pts))

    def W_y(y):
        """W y: [P, 3] -> [C, 6] via observations."""
        yp = y[pt]
        contrib = jnp.einsum("mki,mkj,mj->mi", Jc, Jp, yp)
        return cam_reduce(jax.ops.segment_sum(contrib, cam, n_cams))

    def S_matvec(x):
        Ux = jnp.einsum("cij,cj->ci", U, x) + lam * x
        y = W_T_x(x)
        z = jnp.einsum("pij,pj->pi", Vinv, y)
        return Ux - W_y(z)

    rhs = -bc + W_y(jnp.einsum("pij,pj->pi", Vinv, bp))
    x0 = jnp.zeros_like(rhs)
    if psum_axis:
        # under shard_map the psum outputs are 'varying' over the mesh axis;
        # CG's carry must start with the same vma type
        axes = (psum_axis,) if isinstance(psum_axis, str) else psum_axis
        x0 = jax.lax.pcast(x0, axes, to="varying")
    dc, _ = jax.scipy.sparse.linalg.cg(S_matvec, rhs, x0=x0,
                                       maxiter=cg_iters)
    dp = jnp.einsum("pij,pj->pi", Vinv, -bp - W_T_x(dc))
    return dc, dp


@partial(jax.jit, static_argnames=("n_cams", "n_pts", "iters", "cg_iters"))
@highest_precision
def bundle_adjust(R, t, X, prob: BAProblem, n_cams: int, n_pts: int,
                  iters: int = 8, cg_iters: int = 30, lam0: float = 1e-3,
                  fixed_cam_mask=None):
    """Levenberg-Marquardt sparse BA.

    Args:
      R, t: camera poses [C, 3, 3], [C, 3] (world -> camera).
      X: landmarks [P, 3].
      prob: observation list.
      n_cams, n_pts: static sizes (== C, P).
      iters: LM iterations (static).
      cg_iters: CG iterations per Schur solve (static).
      lam0: initial LM damping.
      fixed_cam_mask: [C] bool gauge fixing (default: camera 0 fixed).

    Returns: (R, t, X, final_cost).
    """
    if fixed_cam_mask is None:
        fixed_cam_mask = jnp.zeros(n_cams, bool).at[0].set(True)
    free = (~fixed_cam_mask).astype(R.dtype)[:, None]

    def lm_step(state, _):
        R, t, X, lam = state
        r, Jc, Jp = _obs_jacobians(R, t, X, prob)
        Jc = Jc * free[prob.cam][:, :, None].transpose(0, 2, 1)
        dc, dp = _schur_solve(r, Jc, Jp, prob, n_cams, n_pts, lam, cg_iters)
        dc = dc * free
        dR, dt = se3_exp(dc)
        R2, t2 = se3_compose(R, t, dR, dt)
        X2 = X + dp
        c_old = ba_cost(R, t, X, prob)
        c_new = ba_cost(R2, t2, X2, prob)
        better = c_new < c_old
        R = jnp.where(better, R2, R)
        t = jnp.where(better, t2, t)
        X = jnp.where(better, X2, X)
        lam = jnp.where(better, lam * 0.5, lam * 4.0)
        lam = jnp.clip(lam, 1e-9, 1e6)
        return (R, t, X, lam), c_new

    state = (R, t, X, jnp.float32(lam0))
    (R, t, X, _), _ = jax.lax.scan(lm_step, state, None, length=iters)
    return R, t, X, ba_cost(R, t, X, prob)
