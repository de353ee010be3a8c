"""Trajectory-accuracy evaluation: ATE RMSE on a synthetic 3D sequence.

KITTI/TUM sequences cannot be fetched in this zero-egress environment, so
the odometry accuracy metric of the north star is evaluated on a synthetic
trajectory with exact ground truth: a 3D landmark field observed by a
camera on a smooth trajectory, features rendered at their projected
locations with per-landmark unique binary descriptors (matching is then
exact and the measured error is the *geometry* error of the two-view
chain + pose-graph back-end).

Pipeline under test: match -> batched RANSAC essential -> pose chaining
with median-depth scale propagation -> pose-graph optimization over
odometry + skip-2 edges.  Prints one JSON line with ATE RMSE (Umeyama
aligned, in units of the trajectory scale).

Run: python benchmarks/odometry_eval.py [--frames N]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

# fallback when akaze_jax is not pip-installed: add the repo root
sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def simulate(rng, n_frames: int, n_pts: int = 400):
    """Ground-truth trajectory + landmark projections."""
    import jax.numpy as jnp
    from akaze_jax.geometry import se3_exp, se3_inverse, se3_compose

    X = rng.uniform([-6, -4, 8], [6, 4, 24], (n_pts, 3)).astype(np.float64)
    Rs, ts = [], []
    Rw = np.eye(3)
    tw = np.zeros(3)
    for k in range(n_frames):
        # camera-to-world motion: forward + gentle arc
        xi = np.asarray([0.05, 0.0, 0.55, 0.0, 0.035, 0.005], np.float32)
        if k:
            dR, dt = se3_exp(jnp.asarray(xi))
            Rw2 = Rw @ np.asarray(dR)
            tw2 = Rw @ np.asarray(dt) + tw
            Rw, tw = Rw2, tw2
        Ri, ti = se3_inverse(jnp.asarray(Rw, jnp.float32),
                             jnp.asarray(tw, jnp.float32))
        Rs.append(np.asarray(Ri))
        ts.append(np.asarray(ti))
    return X, np.stack(Rs), np.stack(ts)  # world->cam per frame


def project_frame(X, R, t, words, intr, n_pad, noise, rng):
    from akaze_jax.pipeline import Features
    import jax.numpy as jnp
    fx, fy, cx, cy = intr
    Xc = X @ R.T + t
    uv = Xc[:, :2] / Xc[:, 2:3]
    px = uv[:, 0] * fx + cx + rng.standard_normal(len(X)) * noise
    py = uv[:, 1] * fy + cy + rng.standard_normal(len(X)) * noise
    vis = (Xc[:, 2] > 1.0) & (px > 0) & (px < 2 * cx) & (py > 0) \
        & (py < 2 * cy)
    n = len(X)
    pad = n_pad - n

    def p(v, fill=0):
        return jnp.asarray(np.concatenate(
            [v.astype(np.float32), np.full(pad, fill, np.float32)]))

    return Features(
        x=p(px), y=p(py), size=p(np.full(n, 4.0)),
        layer=jnp.zeros(n_pad, jnp.int32),
        response=p(np.ones(n)), angle=p(np.zeros(n)),
        words=jnp.asarray(np.concatenate(
            [words, np.zeros((pad, 16), np.uint32)])),
        valid=jnp.asarray(np.concatenate(
            [vis, np.zeros(pad, bool)])),
        count=jnp.int32(int(vis.sum())))


def load_kitti_intrinsics(kitti_dir, frame_shape):
    """Intrinsics from calib.txt's P0 row when present, else a generic
    default from the frame size."""
    calib = os.path.join(kitti_dir, "calib.txt")
    if os.path.exists(calib):
        with open(calib) as f:
            for line in f:
                if line.startswith("P0:"):
                    v = [float(x) for x in line.split()[1:]]
                    return v[0], v[5], v[2], v[6]
    h, w = frame_shape
    return 0.9 * w, 0.9 * w, w / 2.0, h / 2.0


def run_kitti(kitti_dir, max_frames):
    """Real-sequence mode: KITTI odometry layout (image_0/ + poses.txt).

    Runs the actual AKAZE VisualOdometry over the frames and scores ATE
    RMSE against the ground-truth trajectory.
    """
    from akaze_jax import AkazeConfig
    from akaze_jax.io import FrameSequence, load_kitti_poses, ate_rmse
    from akaze_jax.slam.odometry import Intrinsics, VisualOdometry

    seq = FrameSequence(os.path.join(kitti_dir, "image_0"))
    R_gt, t_gt = load_kitti_poses(os.path.join(kitti_dir, "poses.txt"))
    frames = []
    for k, img in enumerate(seq):
        if max_frames and k >= max_frames:
            break
        frames.append(img)
    n = len(frames)
    fx, fy, cx, cy = load_kitti_intrinsics(kitti_dir, frames[0].shape)
    vo = VisualOdometry(Intrinsics(fx, fy, cx, cy),
                        AkazeConfig(max_pts=4000))
    for img in frames:
        vo.process(img.astype(np.float32) / 255.0)
    traj = vo.trajectory()
    # KITTI poses are camera-to-world: the translation IS the position
    c_gt = t_gt[:n]
    rec = {
        "metric": "KITTI odometry ATE RMSE (Umeyama aligned)",
        "dir": kitti_dir,
        "frames": n,
        "ate": round(ate_rmse(traj, c_gt), 4),
        "keyframes": len(vo.keyframes),
    }
    print(json.dumps(rec))
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--noise", type=float, default=0.3,
                    help="pixel noise sigma")
    ap.add_argument("--kitti-dir", default=None,
                    help="KITTI odometry sequence dir (image_0/ + "
                         "poses.txt [+ calib.txt]); synthetic otherwise")
    args = ap.parse_args()
    if args.kitti_dir:
        return run_kitti(args.kitti_dir, args.frames)

    import jax
    import jax.numpy as jnp
    from akaze_jax.io import ate_rmse
    from akaze_jax.slam.odometry import Intrinsics, _two_view
    from akaze_jax.slam import PoseGraph, optimize_pose_graph

    rng = np.random.default_rng(7)
    intr = (600.0, 600.0, 320.0, 240.0)
    X, R_gt, t_gt = simulate(rng, args.frames)
    n_pts = len(X)
    words = rng.integers(0, 2 ** 32, (n_pts, 16),
                         dtype=np.uint64).astype(np.uint32)
    words[:, 15] &= np.uint32((1 << 6) - 1)
    n_pad = 512
    feats = [project_frame(X, R_gt[k], t_gt[k], words, intr, n_pad,
                           args.noise, rng)
             for k in range(args.frames)]

    # two-view chain with median-depth scale propagation
    ii = Intrinsics(*intr)
    key = jax.random.PRNGKey(0)
    R_est = [np.eye(3, dtype=np.float32)]
    t_est = [np.zeros(3, np.float32)]
    edges = []
    prev_med = None
    scale = 1.0
    for k in range(1, args.frames):
        key, sub = jax.random.split(key)
        m, res, X1, z1, z2 = _two_view(
            sub, feats[k - 1], feats[k], ii.fx, ii.fy, ii.cx, ii.cy, 2e-5)
        inl = np.asarray(res.inliers)
        z = np.asarray(z1)[inl]
        med = float(np.median(z[z > 0]))
        if prev_med is not None:
            scale = scale * prev_med / max(med, 1e-9)
        prev_med = med
        R_rel = np.asarray(res.R)
        t_rel = np.asarray(res.t) * scale
        R_est.append(R_rel @ R_est[-1])
        t_est.append(R_rel @ t_est[-1] + t_rel)
        # edge convention is T_ij = T_{k-1}^-1 T_k; the chained estimate
        # embodies exactly the two-view measurement, so the relative of the
        # chain IS the measurement in the edge frame (zero initial residual)
        Ra, ta = R_est[-2], t_est[-2]
        edges.append((k - 1, k, Ra.T @ R_est[-1],
                      Ra.T @ (t_est[-1] - ta), 1.0))

    # skip-2 edges strengthen the graph (simulated loop constraints)
    for k in range(2, args.frames):
        key, sub = jax.random.split(key)
        m, res, X1, z1, z2 = _two_view(
            sub, feats[k - 2], feats[k], ii.fx, ii.fy, ii.cx, ii.cy, 2e-5)
        inl = np.asarray(res.inliers)
        z = np.asarray(z1)[inl]
        if not (z > 0).any():
            continue
        # res: T_k = T_rel T_{k-2}; the edge expects T_{k-2}^-1 T_k, so
        # conjugate by T_{k-2} and scale the unit translation so it matches
        # t_rel ~= t_k - R_rel t_{k-2} from the chained estimates
        R_rel = np.asarray(res.R, np.float64)
        Ra = np.asarray(R_est[k - 2], np.float64)
        ta = np.asarray(t_est[k - 2], np.float64)
        tb = np.asarray(t_est[k], np.float64)
        s = float(np.linalg.norm(tb - R_rel @ ta))
        t_rel = np.asarray(res.t, np.float64) * s
        edges.append((k - 2, k,
                      (Ra.T @ R_rel @ Ra).astype(np.float32),
                      (Ra.T @ (R_rel @ ta + t_rel - ta)).astype(np.float32),
                      0.5))

    g = PoseGraph(
        i=jnp.asarray([e[0] for e in edges], jnp.int32),
        j=jnp.asarray([e[1] for e in edges], jnp.int32),
        R_ij=jnp.asarray(np.stack([e[2] for e in edges])),
        t_ij=jnp.asarray(np.stack([e[3] for e in edges])),
        weight=jnp.asarray([e[4] for e in edges], jnp.float32))
    R_opt, t_opt, cost = optimize_pose_graph(
        jnp.asarray(np.stack(R_est)), jnp.asarray(np.stack(t_est)), g,
        iters=10)

    def centers(R, t):
        return np.stack([-(np.asarray(R[k]).T @ np.asarray(t[k]))
                         for k in range(args.frames)])

    c_gt = centers(R_gt, t_gt)
    c_chain = centers(np.stack(R_est), np.stack(t_est))
    c_opt = centers(np.asarray(R_opt), np.asarray(t_opt))
    traj_len = float(np.linalg.norm(np.diff(c_gt, axis=0), axis=1).sum())

    rec = {
        "metric": "synthetic odometry ATE RMSE (Umeyama aligned)",
        "frames": args.frames,
        "trajectory_length": round(traj_len, 3),
        "ate_chain": round(ate_rmse(c_chain, c_gt), 4),
        "ate_pgo": round(ate_rmse(c_opt, c_gt), 4),
        "pgo_cost": float(cost),
    }
    print(json.dumps(rec))
    assert rec["ate_pgo"] < 0.05 * traj_len, "ATE above 5% of trajectory"
    return rec


if __name__ == "__main__":
    main()
