"""Long-sequence SLAM trajectory benchmark: ATE over 100+ frames with
real loop closures.

KITTI itself cannot be fetched here (zero-egress), so this drives the full
``SlamSystem`` machinery — keyframing, descriptor loop-closure retrieval
(KeyframeIndex), pose-graph optimization, windowed bundle adjustment,
capacity-bucketed solvers — over a KITTI-style synthetic sequence with
exact ground truth: a camera driving two laps of a circular track through
a fixed 3D landmark field (lap 2 revisits lap 1's views, so loop closures
are real, not simulated edges).  The front-end is replaced by exact
projected features with unique per-landmark descriptors, so the measured
error is the SLAM back-end's geometry error at scale — the 12-frame rig of
benchmarks/odometry_eval.py cannot catch drift regressions past a dozen
keyframes.

Ground-truth and estimated trajectories are written in KITTI pose format
(io.save_kitti_poses); ATE is Umeyama-aligned RMSE (io.ate_rmse).
Per-frame wall times are recorded to evidence the bucketed solvers' flat
compile behaviour.

Run: python benchmarks/long_sequence_eval.py [--frames 120] [--out DIR]
Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

FX = FY = 600.0
CX, CY = 320.0, 240.0


def make_world(rng, n_pts: int = 1500, radius: float = 20.0):
    """Landmark field around a circular track: a ring band outside the
    track plus scattered near-track structure, heights around camera
    level."""
    ang = rng.uniform(0, 2 * np.pi, n_pts)
    rad = rng.uniform(radius * 1.2, radius * 2.4, n_pts)
    y = rng.uniform(-4.0, 6.0, n_pts)
    X = np.stack([rad * np.sin(ang), y, rad * np.cos(ang)], axis=1)
    return X.astype(np.float64)


def track_pose(theta: float, radius: float):
    """World->camera pose of a camera driving the circle (y up, camera z
    forward along the tangent, y down)."""
    c = np.asarray([radius * np.sin(theta), 0.0, radius * np.cos(theta)])
    fwd = np.asarray([np.cos(theta), 0.0, -np.sin(theta)])
    up = np.asarray([0.0, 1.0, 0.0])
    right = np.cross(up, fwd)
    right /= np.linalg.norm(right)
    # camera axes in world coords: x right, y down, z forward
    R_wc = np.stack([right, -up, fwd], axis=1)
    R = R_wc.T
    t = -R @ c
    return R.astype(np.float32), t.astype(np.float32)


def project(X, words, R, t, n_pad, noise, rng):
    """Exact projected Features (unique descriptors -> exact matching)."""
    import jax.numpy as jnp
    from akaze_jax.pipeline import Features

    Xc = X @ R.T.astype(np.float64) + t.astype(np.float64)
    z = Xc[:, 2]
    uv = Xc[:, :2] / np.where(np.abs(z[:, None]) < 1e-9, 1e-9, z[:, None])
    px = uv[:, 0] * FX + CX + rng.standard_normal(len(X)) * noise
    py = uv[:, 1] * FY + CY + rng.standard_normal(len(X)) * noise
    vis = (z > 2.0) & (z < 60.0) & (px > 0) & (px < 2 * CX) \
        & (py > 0) & (py < 2 * CY)
    idx = np.nonzero(vis)[0]
    if len(idx) > n_pad:
        idx = idx[:n_pad]
    n = len(idx)
    pad = n_pad - n

    def p(v):
        return jnp.asarray(np.concatenate(
            [v[idx].astype(np.float32), np.zeros(pad, np.float32)]))

    return Features(
        x=p(px), y=p(py), size=p(np.full(len(X), 4.0)),
        layer=jnp.zeros(n_pad, jnp.int32), response=p(np.ones(len(X))),
        angle=p(np.zeros(len(X))),
        words=jnp.asarray(np.concatenate(
            [words[idx], np.zeros((pad, 16), np.uint32)])),
        valid=jnp.asarray(np.concatenate([np.ones(n, bool),
                                          np.zeros(pad, bool)])),
        count=jnp.int32(n), overflow=jnp.asarray(False))


class _FeatureFrontend:
    """Stand-in Akaze: detect_and_compute(frame_index_image) -> the
    precomputed exact features of that frame."""

    def __init__(self, feats):
        self.feats = feats

    def detect_and_compute(self, image, describe: bool = True):
        return self.feats[int(np.asarray(image).ravel()[0])]


def run(n_frames: int = 120, noise: float = 0.3, seed: int = 3,
        mesh=None, out_dir=None, local_ba_every: int = 6, laps: int = 2,
        n_world_pts: int = 1500, n_pad: int = 512, slam_overrides=None,
        chain: bool = True):
    """``chain``: also run the unoptimised chained baseline (``ate_chain``;
    None when off)."""
    import dataclasses

    from akaze_jax.io import ate_rmse, save_kitti_poses
    from akaze_jax.slam import SlamSystem, SlamConfig
    from akaze_jax.slam.odometry import Intrinsics

    rng = np.random.default_rng(seed)
    radius = 20.0
    X = make_world(rng, n_world_pts, radius=radius)
    words = rng.integers(0, 2 ** 32, (len(X), 16),
                         dtype=np.uint64).astype(np.uint32)
    words[:, 15] &= np.uint32((1 << 6) - 1)

    thetas = np.linspace(0, laps * 2 * np.pi, n_frames, endpoint=False)
    R_gt = np.zeros((n_frames, 3, 3), np.float32)
    t_gt = np.zeros((n_frames, 3), np.float32)
    feats = []
    for k, th in enumerate(thetas):
        R_gt[k], t_gt[k] = track_pose(th, radius)
        feats.append(project(X, words, R_gt[k], t_gt[k], n_pad, noise,
                             rng))

    intr = Intrinsics(FX, FY, CX, CY)
    slam_cfg = SlamConfig(
        optimize_every=4, min_loop_gap=10, loop_candidates=3,
        loop_min_matches=40, loop_min_inliers=25,
        local_ba_every=local_ba_every, local_ba_window=4,
        local_ba_points=256)
    if slam_overrides:
        slam_cfg = dataclasses.replace(slam_cfg, **slam_overrides)
    slam = SlamSystem(
        intr, slam_config=slam_cfg,
        mesh=mesh, min_inliers=20, keyframe_inlier_ratio=0.7)
    slam.vo.akaze = _FeatureFrontend(feats)

    from collections import defaultdict
    prof = defaultdict(float)
    slam.prof = prof
    slam.vo.prof = prof

    frame_ms = []
    sections = set()
    for k in range(n_frames):
        if k == n_frames // 2:
            sections.update(prof)
            prof.clear()   # steady-state profile: second half only
        t0 = time.time()
        slam.process(np.full((2, 2), k, np.float32))
        frame_ms.append((time.time() - t0) * 1000)
    sections.update(prof)
    slam.optimize(iters=10)

    kf_idx = [kf.index for kf in slam.vo.keyframes]
    c_est = slam.keyframe_trajectory()
    c_gt = np.stack([-(R_gt[i].T @ t_gt[i]) for i in kf_idx])
    traj_len = float(np.linalg.norm(np.diff(c_gt, axis=0), axis=1).sum())
    loops = [e for e in slam.edges if e[1] != e[0] - 1 and e[0] != e[1] - 1]

    # chained (no optimization) baseline for the same sequence
    ate_chain = None
    if chain:
        base = SlamSystem(
            intr, slam_config=SlamConfig(optimize_every=10 ** 9,
                                         min_loop_gap=10 ** 9),
            min_inliers=20, keyframe_inlier_ratio=0.7)
        base.vo.akaze = _FeatureFrontend(feats)
        for k in range(n_frames):
            base.process(np.full((2, 2), k, np.float32))
        c_gt_c = np.stack([-(R_gt[kf.index].T @ t_gt[kf.index])
                           for kf in base.vo.keyframes])
        ate_chain = round(float(ate_rmse(base.keyframe_trajectory(),
                                         c_gt_c)), 4)

    fm = np.asarray(frame_ms)
    half = len(fm) // 2
    wu = min(10, max(half - 1, 0))    # warmup frames excluded from stats
    warm = fm[wu:]
    rec = {
        "metric": "long-sequence SLAM ATE (Umeyama aligned)",
        "frames": n_frames,
        "keyframes": len(kf_idx),
        "keyframe_index": kf_idx,
        "sections": sorted(sections),
        "loop_edges": len(loops),
        "trajectory_length": round(traj_len, 3),
        "ate_chain": ate_chain,
        "ate_slam": round(float(ate_rmse(c_est, c_gt)), 4),
        "ate_slam_pct": round(100 * float(ate_rmse(c_est, c_gt))
                              / traj_len, 3),
        "frame_ms_first_half": round(float(np.mean(fm[wu:half])), 1),
        "frame_ms_second_half": round(float(np.mean(fm[half:])), 1),
        "frame_ms_p95": round(float(np.percentile(warm, 95)), 1),
        # steady-state host-path attribution (second half; ms per frame)
        "host_profile_ms": {k: round(v / max(n_frames - half, 1) * 1000, 1)
                            for k, v in sorted(prof.items())},
    }
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)

        def c2w(R, t):
            """world->cam to KITTI's camera-to-world [R|t] rows."""
            Rcw = np.transpose(R, (0, 2, 1))
            tcw = -np.einsum("kij,kj->ki", Rcw, t)
            return Rcw, tcw

        save_kitti_poses(os.path.join(out_dir, "poses_gt.txt"),
                         *c2w(R_gt[kf_idx], t_gt[kf_idx]))
        R_est = np.stack([kf.R for kf in slam.vo.keyframes])
        t_est = np.stack([kf.t for kf in slam.vo.keyframes])
        save_kitti_poses(os.path.join(out_dir, "poses_slam.txt"),
                         *c2w(R_est, t_est))
        with open(os.path.join(out_dir, "long_seq.json"), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--noise", type=float, default=0.3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    rec = run(args.frames, args.noise, out_dir=args.out)
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
