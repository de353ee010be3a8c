"""BASELINE config 2: stereo pair + RANSAC essential-matrix two-view pose.

Runs the full front-end on the reference's left/right pair (a wide-baseline
view pair — median match displacement is ~530 px with rotation, not a
rectified rig; where ``data/`` lacks it, on the seeded synthetic pair of
the same shape, a pure translation, io.stock_pair), then estimates the relative camera pose from the AKAZE
matches with batched-hypothesis RANSAC.  Quality metrics: inlier fraction
of the putative matches and the Sampson-error statistics of the inliers
under the recovered essential matrix.

Run: python benchmarks/stereo_pose.py
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

# fallback when akaze_jax is not pip-installed: add the repo root
sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main():
    import jax
    import jax.numpy as jnp
    from akaze_jax import Akaze, AkazeConfig
    from akaze_jax.io import stock_pair
    from akaze_jax.geometry import ransac_essential, so3_log
    from akaze_jax.geometry.ransac import normalize_points

    left, right, source = stock_pair()
    print(f"pair: {source}")
    h, w = left.shape
    # nominal intrinsics (no calibration shipped with the pair): f = w,
    # principal point at center — adequate for direction-of-motion recovery
    fx = fy = float(w)
    cx, cy = w / 2.0, h / 2.0

    det = Akaze(AkazeConfig(max_pts=10000))
    fa = det.detect_and_compute(left.astype(np.float32) / 255.0)
    fb = det.detect_and_compute(right.astype(np.float32) / 255.0)
    m = det.match(fa, fb)

    x1 = normalize_points(jnp.stack([fa.x, fa.y], -1), fx, fy, cx, cy)
    x2 = normalize_points(jnp.stack([m.match_x, m.match_y], -1),
                          fx, fy, cx, cy)
    putative = (m.index >= 0) & fa.valid

    t0 = time.time()
    res = ransac_essential(jax.random.PRNGKey(0), x1, x2, putative,
                           threshold=2e-5, num_hyps=512)
    jax.block_until_ready(res.E)
    ransac_s = time.time() - t0

    from akaze_jax.geometry import sampson_error
    R = np.asarray(res.R)
    t = np.asarray(res.t)
    rot_deg = float(np.degrees(np.linalg.norm(
        np.asarray(so3_log(jnp.asarray(R))))))
    err = np.asarray(sampson_error(res.E, x1, x2))
    inl = np.asarray(res.inliers)
    n_put = int(np.asarray(putative).sum())
    # Sampson error in squared pixels (normalized units * f^2)
    err_px2 = err[inl] * fx * fx
    rec = {
        "metric": "two-view pose on the reference pair",
        "n_keypoints": [int(fa.count), int(fb.count)],
        "n_putative": n_put,
        "n_inliers": int(res.num_inliers),
        "inlier_fraction": round(int(res.num_inliers) / max(n_put, 1), 3),
        "rotation_deg": round(rot_deg, 2),
        "t_direction": [round(float(v), 4) for v in t],
        "sampson_px2_median": round(float(np.median(err_px2)), 4),
        "ransac_s_incl_compile": round(ransac_s, 2),
    }
    print(json.dumps(rec))
    assert rec["n_inliers"] > 200, "two-view pose: too few inliers"
    assert rec["inlier_fraction"] > 0.3, "two-view pose: inlier rate collapsed"
    assert rec["sampson_px2_median"] < 2.0, "two-view pose: poor epipolar fit"
    return rec


if __name__ == "__main__":
    main()
