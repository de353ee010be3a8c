"""Repeatability + matching-score benchmark (Oxford/Graffiti protocol).

BASELINE.json config 3 calls for viewpoint/blur robustness benchmarking vs
OpenCV AKAZE.  The Oxford images cannot be fetched in this zero-egress
environment and cv2 here lacks features2d, so the protocol runs on
synthetic homography warps of the reference stereo image (or of its seeded
synthetic stand-in, io.stock_pair) with exact ground-truth correspondence:

  repeatability  = |{kp in A : exists kp' in B with ||H kp - kp'|| < eps}|
                   / min(|A in shared region|, |B in shared region|)
  matching score = |correct matches| / min(|A|, |B|)   (match via Hamming,
                   correct when ||H kp - kp'|| < eps)

Run: python benchmarks/repeatability.py  (GPU or CPU)
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

# fallback when akaze_jax is not pip-installed: add the repo root
sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def warp_image(img: np.ndarray, H: np.ndarray) -> np.ndarray:
    """Inverse-map bilinear warp of a grayscale image by homography H
    (maps source coords -> destination coords)."""
    h, w = img.shape
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    Hinv = np.linalg.inv(H)
    den = Hinv[2, 0] * xx + Hinv[2, 1] * yy + Hinv[2, 2]
    sx = (Hinv[0, 0] * xx + Hinv[0, 1] * yy + Hinv[0, 2]) / den
    sy = (Hinv[1, 0] * xx + Hinv[1, 1] * yy + Hinv[1, 2]) / den
    x0 = np.floor(sx).astype(int)
    y0 = np.floor(sy).astype(int)
    fx = sx - x0
    fy = sy - y0
    valid = (x0 >= 0) & (x0 < w - 1) & (y0 >= 0) & (y0 < h - 1)
    x0c = np.clip(x0, 0, w - 2)
    y0c = np.clip(y0, 0, h - 2)
    out = ((1 - fx) * (1 - fy) * img[y0c, x0c]
           + fx * (1 - fy) * img[y0c, x0c + 1]
           + (1 - fx) * fy * img[y0c + 1, x0c]
           + fx * fy * img[y0c + 1, x0c + 1])
    out[~valid] = 0
    return out.astype(img.dtype)


def apply_h(H, x, y):
    den = H[2, 0] * x + H[2, 1] * y + H[2, 2]
    return ((H[0, 0] * x + H[0, 1] * y + H[0, 2]) / den,
            (H[1, 0] * x + H[1, 1] * y + H[1, 2]) / den)


def rotation_homography(angle_deg: float, cx: float, cy: float,
                        scale: float = 1.0) -> np.ndarray:
    a = np.deg2rad(angle_deg)
    R = np.asarray([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
    R = R * scale
    t = np.asarray([cx, cy]) - R @ np.asarray([cx, cy])
    H = np.eye(3)
    H[:2, :2] = R
    H[:2, 2] = t
    return H


def perspective_homography(strength: float, w: int, h: int) -> np.ndarray:
    H = np.eye(3)
    H[2, 0] = strength / w
    H[2, 1] = strength / (2 * h)
    return H


def evaluate_pair(det, img_a, H, eps: float = 2.5):
    import jax
    img_b = warp_image(img_a, H)
    fa = det.detect_and_compute(img_a.astype(np.float32) / 255.0)
    fb = det.detect_and_compute(img_b.astype(np.float32) / 255.0)
    m = det.match(fa, fb)
    na, nb = int(fa.count), int(fb.count)
    ax = np.asarray(fa.x)[:na]
    ay = np.asarray(fa.y)[:na]
    bx = np.asarray(fb.x)[:nb]
    by = np.asarray(fb.y)[:nb]
    h, w = img_a.shape

    # project A into B, keep the shared region
    px, py = apply_h(H, ax, ay)
    in_b = (px >= 0) & (px < w) & (py >= 0) & (py < h)
    # B keypoints that land back inside A
    qx, qy = apply_h(np.linalg.inv(H), bx, by)
    in_a = (qx >= 0) & (qx < w) & (qy >= 0) & (qy < h)
    denom = max(min(int(in_b.sum()), int(in_a.sum())), 1)

    # repeatability: nearest B keypoint within eps of each projected A kp
    d2 = ((px[in_b][:, None] - bx[None, :]) ** 2
          + (py[in_b][:, None] - by[None, :]) ** 2)
    repeated = int((d2.min(axis=1) < eps * eps).sum()) if nb else 0

    # matching score: accepted matches that are geometrically correct
    idx = np.asarray(m.index)[:na]
    acc = idx >= 0
    mx = np.asarray(m.match_x)[:na][acc]
    my = np.asarray(m.match_y)[:na][acc]
    cx_, cy_ = px[acc], py[acc]
    correct = int((((mx - cx_) ** 2 + (my - cy_) ** 2) < eps * eps).sum())

    # estimate H back from the raw matches (exercises the RANSAC
    # homography end-to-end) and compare against the ground truth by the
    # mean corner transfer error
    import jax
    import jax.numpy as jnp
    from akaze_jax.geometry import ransac_homography
    x1m = jnp.asarray(np.stack([np.asarray(fa.x), np.asarray(fa.y)], -1))
    x2m = jnp.asarray(np.stack([np.asarray(m.match_x),
                                np.asarray(m.match_y)], -1))
    putative = jnp.asarray(np.asarray(m.index) >= 0)
    res = ransac_homography(jax.random.PRNGKey(0), x1m, x2m, putative,
                            threshold=4.0, num_hyps=256)
    Hh = np.asarray(res.H)
    Hh = Hh / Hh[2, 2]
    corners = np.asarray([[0, 0], [w - 1, 0], [0, h - 1],
                          [w - 1, h - 1]], np.float64)
    gx, gy = apply_h(H, corners[:, 0], corners[:, 1])
    ex, ey = apply_h(Hh, corners[:, 0], corners[:, 1])
    h_err = float(np.mean(np.hypot(gx - ex, gy - ey)))

    return {"n_a": na, "n_b": nb,
            "repeatability": repeated / denom,
            "matching_score": correct / denom,
            "n_matches": int(acc.sum()), "n_correct": correct,
            "h_inliers": int(res.num_inliers),
            "h_corner_err_px": round(h_err, 3)}


def main():
    from akaze_jax import Akaze, AkazeConfig
    from akaze_jax.io import stock_pair

    img = stock_pair()[0][::2, ::2]  # 480x640
    h, w = img.shape
    det = Akaze(AkazeConfig(max_pts=4000))

    cases = {
        "rot10": rotation_homography(10, w / 2, h / 2),
        "rot30": rotation_homography(30, w / 2, h / 2),
        "scale0.8+rot15": rotation_homography(15, w / 2, h / 2, 0.8),
        "perspective": perspective_homography(0.15, w, h),
    }
    results = {}
    for name, H in cases.items():
        results[name] = evaluate_pair(det, img, H)
        r = results[name]
        print(f"{name:16s} rep={r['repeatability']:.3f} "
              f"score={r['matching_score']:.3f} "
              f"({r['n_correct']}/{r['n_matches']} correct, "
              f"kps {r['n_a']}/{r['n_b']}, "
              f"H: {r['h_inliers']} inl, {r['h_corner_err_px']} px)")
    mean_rep = float(np.mean([r["repeatability"] for r in results.values()]))
    mean_ms = float(np.mean([r["matching_score"] for r in results.values()]))
    print(json.dumps({"metric": "homography repeatability / matching score",
                      "repeatability": round(mean_rep, 4),
                      "matching_score": round(mean_ms, 4)}))
    return results


if __name__ == "__main__":
    main()
