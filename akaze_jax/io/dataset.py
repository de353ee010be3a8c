"""Dataset utilities: image-sequence readers and synthetic generators.

The reference loads exactly two hardcoded images via OpenCV
(main.cpp:139-150).  A SLAM/SfM engine needs sequence input: this module
provides a KITTI-odometry-style folder reader (``image_0/NNNNNN.png`` plus
optional ``poses.txt``), a plain glob-ordered frame sequence, and a
synthetic trajectory renderer for tests/benchmarks (zero-egress environment:
real KITTI/TUM data is unavailable, so correctness is validated on
synthetic sequences with exact ground truth).
"""

from __future__ import annotations

import glob
import os
from typing import Iterator, List, Optional, Tuple

import numpy as np

from .image import load_gray


class FrameSequence:
    """Ordered grayscale frame sequence from a directory or glob pattern.

    Uses the native threaded prefetch loader for ``.pgm`` inputs when
    available, synchronous decode otherwise.
    """

    def __init__(self, pattern: str, prefetch: bool = True):
        if os.path.isdir(pattern):
            paths: List[str] = []
            for ext in ("*.pgm", "*.png", "*.jpg"):
                paths.extend(glob.glob(os.path.join(pattern, ext)))
            self.paths = sorted(paths)
        else:
            self.paths = sorted(glob.glob(pattern))
        if not self.paths:
            raise FileNotFoundError(f"no frames match {pattern!r}")
        self._prefetch = prefetch and all(
            p.lower().endswith(".pgm") for p in self.paths)

    def __len__(self) -> int:
        return len(self.paths)

    def __iter__(self) -> Iterator[np.ndarray]:
        if self._prefetch:
            from ..native import FrameLoader, get_lib
            if get_lib() is not None:
                loader = FrameLoader(self.paths)
                try:
                    yield from loader
                finally:
                    loader.close()
                return
        for p in self.paths:
            yield load_gray(p)


def load_kitti_poses(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """KITTI odometry ground-truth format: each line is a row-major 3x4
    [R | t] matrix (camera-to-world).  Returns (R [N,3,3], t [N,3])."""
    rows = np.loadtxt(path, dtype=np.float64).reshape(-1, 3, 4)
    return (rows[:, :, :3].astype(np.float32),
            rows[:, :, 3].astype(np.float32))


def save_kitti_poses(path: str, R: np.ndarray, t: np.ndarray) -> None:
    mat = np.concatenate([np.asarray(R), np.asarray(t)[:, :, None]], axis=2)
    np.savetxt(path, mat.reshape(len(mat), 12), fmt="%.9e")


def ate_rmse(t_est: np.ndarray, t_gt: np.ndarray,
             align: bool = True) -> float:
    """Absolute trajectory error (RMSE of translation) after optional
    similarity (Umeyama) alignment — the standard KITTI/TUM metric."""
    est = np.asarray(t_est, np.float64)
    gt = np.asarray(t_gt, np.float64)
    assert est.shape == gt.shape
    if align and len(est) >= 3:
        mu_e, mu_g = est.mean(0), gt.mean(0)
        e, g = est - mu_e, gt - mu_g
        cov = g.T @ e / len(e)
        U, D, Vt = np.linalg.svd(cov)
        S = np.eye(3)
        if np.linalg.det(U) * np.linalg.det(Vt) < 0:
            S[2, 2] = -1
        R = U @ S @ Vt
        var_e = (e ** 2).sum() / len(e)
        s = np.trace(np.diag(D) @ S) / max(var_e, 1e-12)
        est = s * (est - mu_e) @ R.T + mu_g
    return float(np.sqrt(((est - gt) ** 2).sum(axis=1).mean()))


def synthetic_sequence(rng, n_frames: int = 8, size: Tuple[int, int] =
                       (240, 320), shift_per_frame: Tuple[float, float] =
                       (4.0, 2.0), n_blobs: int = 60):
    """Render a translating view over a random blob field.

    Returns (frames [N, H, W] uint8, true per-frame pixel offsets [N, 2]).
    Pure-translation imagery — enough to exercise detection, matching and
    tracking loops with known pixel-space ground truth.
    """
    h, w = size
    dy, dx = shift_per_frame
    max_y = int(abs(dy) * n_frames + 20)
    max_x = int(abs(dx) * n_frames + 20)
    big_h, big_w = h + 2 * max_y, w + 2 * max_x
    yy, xx = np.mgrid[0:big_h, 0:big_w].astype(np.float64)
    world = np.zeros((big_h, big_w))
    cy = rng.uniform(10, big_h - 10, n_blobs)
    cx = rng.uniform(10, big_w - 10, n_blobs)
    sig = rng.uniform(2, 8, n_blobs)
    amp = rng.uniform(0.3, 1.0, n_blobs)
    for c_y, c_x, s, a in zip(cy, cx, sig, amp):
        m = ((np.abs(yy - c_y) < 4 * s) & (np.abs(xx - c_x) < 4 * s))
        world[m] += a * np.exp(-((yy[m] - c_y) ** 2 + (xx[m] - c_x) ** 2)
                               / (2 * s * s))
    world += 0.03 * rng.standard_normal(world.shape)
    world = np.clip(world / max(world.max(), 1e-6), 0, 1)

    frames = []
    offsets = []
    for k in range(n_frames):
        oy = int(round(max_y + k * dy))
        ox = int(round(max_x + k * dx))
        frames.append((world[oy:oy + h, ox:ox + w] * 255).astype(np.uint8))
        offsets.append((oy - max_y, ox - max_x))
    return np.stack(frames), np.asarray(offsets, np.float32)


def textured_image(shape: Tuple[int, int], seed: int = 0,
                   alpha: float = 1.2) -> np.ndarray:
    """Seeded natural-looking texture: 1/f^alpha ("pink") noise, the power
    spectrum of natural images, scaled to uint8.  Dense in blobs at every
    scale, so detection fills the keypoint slots like a real photograph.

    Returns an [H, W] uint8 image.
    """
    h, w = shape
    rng = np.random.default_rng(seed)
    spec = np.fft.rfft2(rng.standard_normal((h, w)))
    f = np.hypot(np.fft.fftfreq(h)[:, None], np.fft.rfftfreq(w)[None, :])
    f[0, 0] = 1.0
    img = np.fft.irfft2(spec / f ** alpha, s=(h, w))
    lo, hi = np.percentile(img, (0.5, 99.5))
    return np.clip((img - lo) / (hi - lo) * 255.0, 0, 255).astype(np.uint8)


def synthetic_pair(shape: Tuple[int, int] = (960, 1280),
                   shift: Tuple[int, int] = (7, 13), seed: int = 0):
    """A textured pair with known ground truth: image B is image A shifted
    by the non-negative integer ``shift`` = (dy, dx), so the point (y, x)
    of A is (y - dy, x - dx) in B.  Stands in for the reference's stock
    stereo pair (same default shape) where that pair is not available.

    Returns (A, B), both [H, W] uint8.
    """
    h, w = shape
    dy, dx = shift
    canvas = textured_image((h + dy, w + dx), seed)
    return canvas[:h, :w], canvas[dy:dy + h, dx:dx + w]


STOCK_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "data")


def stock_pair():
    """The reference's stock stereo pair (``data/left.pgm`` and
    ``data/right.pgm`` in the checkout) when both files are present, else
    ``synthetic_pair()`` at the same shape.

    Returns (left, right, source) with ``source`` "stock" or "synthetic".
    """
    paths = [os.path.join(STOCK_DIR, f) for f in ("left.pgm", "right.pgm")]
    if all(os.path.exists(p) for p in paths):
        return load_gray(paths[0]), load_gray(paths[1]), "stock"
    a, b = synthetic_pair()
    return a, b, "synthetic"
