"""Distributed bundle adjustment: observations sharded over a device mesh.

The north-star distributed component (SURVEY.md §7 step 7): keyframes stay
replicated (camera state is tiny, [C, 6+]), observations — the bulk of the
problem — are partitioned across devices, and every reduction of the
matrix-free Schur CG (``slam/ba.py``) becomes a local segment-sum followed
by one ``psum`` over the mesh axis.  The per-CG-iteration communication is
two [C, 6] / [P, 3] all-reduces; compute (Jacobian products over
the M/N local observations) scales linearly with devices.

The same LM loop as single-chip BA runs *inside* ``shard_map``, replicated
on every device; the psums keep all replicas bit-identical, so no separate
synchronisation is needed.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..geometry.se3 import se3_exp, se3_compose, highest_precision
from ..slam.ba import (BAProblem, _obs_jacobians, _schur_solve, ba_cost)
from .mesh import axis_size, normalize_axes


def pad_observations(prob: BAProblem, multiple: int) -> BAProblem:
    """Pad the observation list to a multiple (weight 0 padding rows)."""
    m = prob.cam.shape[0]
    rem = (-m) % multiple
    if rem == 0:
        return prob
    return BAProblem(
        cam=jnp.pad(prob.cam, (0, rem)),
        pt=jnp.pad(prob.pt, (0, rem)),
        uv=jnp.pad(prob.uv, ((0, rem), (0, 0))),
        w=jnp.pad(prob.w, (0, rem)))


def sharded_bundle_adjust(R, t, X, prob: BAProblem, mesh: Mesh,
                          iters: int = 8, cg_iters: int = 30,
                          lam0: float = 1e-3, axis="data",
                          fixed_cam_mask=None):
    """LM bundle adjustment with observations sharded over ``mesh[axis]``.

    Args mirror ``slam.bundle_adjust``; ``prob`` must be padded to a multiple
    of the mesh axis size (see ``pad_observations``).  ``axis`` may be one
    mesh axis name or a hierarchy ordered innermost-first, e.g.
    ``("chip", "host")`` on a multi-host mesh.  Returns
    (R, t, X, final_cost), all fully replicated.
    """
    axis = normalize_axes(axis)
    n_dev = axis_size(mesh, axis)
    assert prob.cam.shape[0] % n_dev == 0, "pad observations first"
    if fixed_cam_mask is None:
        fixed_cam_mask = jnp.zeros(R.shape[0], bool).at[0].set(True)
    return _run_sharded_ba(R, t, X, prob, fixed_cam_mask, mesh=mesh,
                           iters=iters, cg_iters=cg_iters, lam0=lam0,
                           axis=axis)


# module-level jit: repeated solves at the same (bucketed) shapes reuse one
# compiled program — a per-call jax.jit(closure) recompiled every call
@partial(jax.jit, static_argnames=("mesh", "iters", "cg_iters", "lam0",
                                   "axis"))
@highest_precision
def _run_sharded_ba(R, t, X, prob, fixed_cam_mask, *, mesh, iters,
                    cg_iters, lam0, axis):
    n_cams = R.shape[0]
    n_pts = X.shape[0]

    def local_cost(R, t, X, lprob):
        return jax.lax.psum(ba_cost(R, t, X, lprob), axis)

    # check_vma=False: the outputs are mathematically replicated (every
    # replica runs the identical psum-synchronised LM loop) but the vma type
    # system cannot prove it through lax.scan
    @partial(shard_map, mesh=mesh,
             in_specs=(P(), P(), P(), BAProblem(P(axis), P(axis),
                                                P(axis), P(axis)), P()),
             out_specs=(P(), P(), P(), P()), check_vma=False)
    def run(R, t, X, lprob, fixed_mask):
        free = (~fixed_mask).astype(R.dtype)[:, None]

        def lm_step(state, _):
            R, t, X, lam = state
            r, Jc, Jp = _obs_jacobians(R, t, X, lprob)
            Jc = Jc * free[lprob.cam][:, :, None].transpose(0, 2, 1)
            dc, dp = _schur_solve(r, Jc, Jp, lprob, n_cams, n_pts, lam,
                                  cg_iters, psum_axis=axis)
            dc = dc * free
            dR, dt = se3_exp(dc)
            R2, t2 = se3_compose(R, t, dR, dt)
            X2 = X + dp
            c_old = local_cost(R, t, X, lprob)
            c_new = local_cost(R2, t2, X2, lprob)
            better = c_new < c_old
            R = jnp.where(better, R2, R)
            t = jnp.where(better, t2, t)
            X = jnp.where(better, X2, X)
            lam = jnp.where(better, lam * 0.5, lam * 4.0)
            return (R, t, X, jnp.clip(lam, 1e-9, 1e6)), c_new

        # the psum outputs are 'varying' over the mesh axis in shard_map's
        # type system; mark the (replicated) initial carry to match
        state = jax.lax.pcast((R, t, X, jnp.float32(lam0)), axis,
                              to="varying")
        (R, t, X, _), _ = jax.lax.scan(lm_step, state, None, length=iters)
        return R, t, X, local_cost(R, t, X, lprob)

    return run(R, t, X, prob, fixed_cam_mask)


# ---------------------------------------------------------------------------
# Landmark-sharded BA: map blocks partitioned across devices/hosts
# ---------------------------------------------------------------------------

class LandmarkPartition(NamedTuple):
    """Host-side plan placing each landmark (and all its observations) on
    one shard, so every point-side quantity of the Schur solve is local.

    Arrays are laid out shard-major: shard d owns points
    [d*pts_per_shard, (d+1)*pts_per_shard) and observations
    [d*obs_per_shard, (d+1)*obs_per_shard).  ``pt`` holds *local* point
    indices (0..pts_per_shard-1); ``cam`` stays global (cameras are
    replicated).  ``point_perm`` maps partitioned point rows back to the
    original landmark order (-1 = padding row).
    """
    prob: BAProblem          # reordered observations, local pt indices
    point_perm: np.ndarray   # [n_shards * pts_per_shard] int32 original ids
    pts_per_shard: int
    obs_per_shard: int


def partition_landmarks(prob: BAProblem, n_pts: int, n_shards: int,
                        min_pts_per_shard: int = 0,
                        min_obs_per_shard: int = 0) -> LandmarkPartition:
    """Partition landmarks (and their observations) into ``n_shards`` blocks.

    Greedy balancing: points are assigned to shards round-robin in
    decreasing-observation-count order, which keeps both the point count and
    the observation count per shard within one point's observations of
    balanced.  Padding observations carry weight 0 and reference local point
    0 of their shard (harmless: zero weight zeroes their Jacobians).

    ``min_pts_per_shard``/``min_obs_per_shard`` floor the per-shard
    capacities so callers can bucket them (e.g. to powers of two) and reuse
    one compiled ``landmark_sharded_bundle_adjust`` program as the problem
    grows.
    """
    cam = np.asarray(prob.cam)
    pt = np.asarray(prob.pt)
    uv = np.asarray(prob.uv)
    w = np.asarray(prob.w)
    live = w > 0
    counts = np.bincount(pt[live], minlength=n_pts)

    order = np.argsort(-counts, kind="stable")
    shard_of = np.empty(n_pts, np.int32)
    shard_sizes = np.zeros(n_shards, np.int64)
    shard_pts: list = [[] for _ in range(n_shards)]
    for p in order:
        d = int(np.argmin(shard_sizes))
        shard_of[p] = d
        shard_sizes[d] += max(int(counts[p]), 1)
        shard_pts[d].append(int(p))

    pts_per_shard = max(max(len(s) for s in shard_pts), min_pts_per_shard)
    pts_per_shard = pts_per_shard + (-pts_per_shard) % 8
    obs_dev = [np.nonzero(live & (shard_of[pt] == d))[0]
               for d in range(n_shards)]
    obs_per_shard = max(max(len(o) for o in obs_dev), min_obs_per_shard)
    # round observation rows up to a lane-friendly multiple
    obs_per_shard = obs_per_shard + (-obs_per_shard) % 8

    local_of = np.zeros(n_pts, np.int32)
    point_perm = np.full(n_shards * pts_per_shard, -1, np.int32)
    for d in range(n_shards):
        for li, p in enumerate(shard_pts[d]):
            local_of[p] = li
            point_perm[d * pts_per_shard + li] = p

    m = n_shards * obs_per_shard
    cam2 = np.zeros(m, np.int32)
    pt2 = np.zeros(m, np.int32)
    uv2 = np.zeros((m, 2), np.float32)
    w2 = np.zeros(m, np.float32)
    for d in range(n_shards):
        o = obs_dev[d]
        lo = d * obs_per_shard
        cam2[lo:lo + len(o)] = cam[o]
        pt2[lo:lo + len(o)] = local_of[pt[o]]
        uv2[lo:lo + len(o)] = uv[o]
        w2[lo:lo + len(o)] = w[o]

    prob2 = BAProblem(cam=jnp.asarray(cam2), pt=jnp.asarray(pt2),
                      uv=jnp.asarray(uv2), w=jnp.asarray(w2))
    return LandmarkPartition(prob2, point_perm, pts_per_shard, obs_per_shard)


def gather_points(part: LandmarkPartition, X: np.ndarray) -> jax.Array:
    """[n_pts, 3] landmarks -> shard-major [n_shards*pts_per_shard, 3]."""
    Xp = np.zeros((len(part.point_perm), 3), np.float32)
    sel = part.point_perm >= 0
    Xp[sel] = np.asarray(X)[part.point_perm[sel]]
    return jnp.asarray(Xp)


def scatter_points(part: LandmarkPartition, Xp) -> np.ndarray:
    """Inverse of ``gather_points`` (padding rows dropped)."""
    n_pts = int(part.point_perm.max()) + 1
    X = np.zeros((n_pts, 3), np.float32)
    sel = part.point_perm >= 0
    X[part.point_perm[sel]] = np.asarray(Xp)[sel]
    return X


def landmark_sharded_bundle_adjust(R, t, X, part: LandmarkPartition,
                                   mesh: Mesh, iters: int = 8,
                                   cg_iters: int = 30, lam0: float = 1e-3,
                                   axis="data", fixed_cam_mask=None):
    """LM bundle adjustment with *landmarks* sharded over ``mesh[axis]``.

    The scaling design of SURVEY.md §5 ("map blocks sharded across hosts"):
    each shard owns a block of landmarks plus all observations of those
    landmarks, so V, bp, W^T x and the dp back-substitution are entirely
    local — per-CG-iteration communication is ONE [C, 6] psum (inside W y),
    independent of the landmark count.  Cameras stay replicated ([C, 6] is
    tiny).  Contrast with ``sharded_bundle_adjust``, which shards
    observations arbitrarily and must psum [P, 3]-sized quantities.

    ``X`` is the shard-major landmark tensor from ``gather_points``.
    ``axis`` may be an axis name or an innermost-first tuple like
    ``("chip", "host")``.  Returns (R, t, X_sharded, final_cost); map
    X_sharded back with ``scatter_points``.
    """
    axis = normalize_axes(axis)
    n_dev = axis_size(mesh, axis)
    assert X.shape[0] == n_dev * part.pts_per_shard, \
        "X must come from gather_points with matching shard count"
    if fixed_cam_mask is None:
        fixed_cam_mask = jnp.zeros(R.shape[0], bool).at[0].set(True)
    return _run_landmark_sharded_ba(R, t, X, part.prob, fixed_cam_mask,
                                    mesh=mesh, iters=iters,
                                    cg_iters=cg_iters, lam0=lam0, axis=axis)


@partial(jax.jit, static_argnames=("mesh", "iters", "cg_iters", "lam0",
                                   "axis"))
@highest_precision
def _run_landmark_sharded_ba(R, t, X, prob, fixed_cam_mask, *, mesh, iters,
                             cg_iters, lam0, axis):
    n_cams = R.shape[0]

    def local_cost(R, t, X, lprob):
        return jax.lax.psum(ba_cost(R, t, X, lprob), axis)

    @partial(shard_map, mesh=mesh,
             in_specs=(P(), P(), P(axis), BAProblem(P(axis), P(axis),
                                                    P(axis), P(axis)), P()),
             out_specs=(P(), P(), P(axis), P()), check_vma=False)
    def run(R, t, X, lprob, fixed_mask):
        free = (~fixed_mask).astype(R.dtype)[:, None]
        n_local = X.shape[0]      # local landmark block of this shard

        def lm_step(state, _):
            R, t, X, lam = state
            r, Jc, Jp = _obs_jacobians(R, t, X, lprob)
            Jc = Jc * free[lprob.cam][:, :, None].transpose(0, 2, 1)
            # camera-side reductions psum [C, 6]-shaped data; point-side
            # stays local because each point's observations are local
            dc, dp = _schur_solve(r, Jc, Jp, lprob, n_cams, n_local, lam,
                                  cg_iters, psum_axis=axis,
                                  local_points=True)
            dc = dc * free
            dR, dt = se3_exp(dc)
            R2, t2 = se3_compose(R, t, dR, dt)
            X2 = X + dp
            c_old = local_cost(R, t, X, lprob)
            c_new = local_cost(R2, t2, X2, lprob)
            better = c_new < c_old
            R = jnp.where(better, R2, R)
            t = jnp.where(better, t2, t)
            X = jnp.where(better, X2, X)
            lam = jnp.where(better, lam * 0.5, lam * 4.0)
            return (R, t, X, jnp.clip(lam, 1e-9, 1e6)), c_new

        state = jax.lax.pcast((R, t, X, jnp.float32(lam0)), axis,
                              to="varying")
        (R, t, X, _), _ = jax.lax.scan(lm_step, state, None, length=iters)
        return R, t, X, local_cost(R, t, X, lprob)

    return run(R, t, X, prob, fixed_cam_mask)
