"""End-to-end golden parity: the composed JAX pipeline (scale space ->
detect -> refine -> orient -> describe) against the independent numpy
oracle (golden_pipeline.py), on crops of the seeded textured stock-shape
image at two sizes, float and fixed.

Detection must agree exactly (count, order, position, layer); descriptor
bits are compared with a small tolerance because the oracle accumulates
cell sums sequentially while the pipeline uses matmuls (different f32
summation order flips rare near-tie comparisons).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from akaze_jax import Akaze, AkazeConfig
from golden_pipeline import full_pipeline_golden, DEFAULT_CFG


@pytest.fixture(scope="module")
def base_image(stereo_pair):
    return stereo_pair[0]


def run_pipeline(img_u8, fixed):
    cfg = AkazeConfig(max_pts=2048)
    det = Akaze(cfg, fixed=fixed)
    inp = img_u8 if fixed else img_u8.astype(np.float32) / 255.0
    f = det.detect_and_compute(inp)
    n = int(f.count)
    return {k: np.asarray(v)[:n] for k, v in f._asdict().items()
            if k not in ("count", "overflow")}


def run_golden(img_u8, fixed):
    cfg = dict(DEFAULT_CFG)
    cfg["max_pts"] = 2048
    inp = (img_u8.astype(np.int64) if fixed
           else img_u8.astype(np.float32) / 255.0)
    return full_pipeline_golden(inp, cfg, fixed=fixed)


def assert_parity(got, want, fixed):
    n = len(want["x"])
    assert len(got["x"]) == n, (len(got["x"]), n)
    # row-major emission order must match slot for slot
    np.testing.assert_array_equal(got["layer"], want["layer"])
    np.testing.assert_allclose(got["x"], want["x"], atol=1e-3)
    np.testing.assert_allclose(got["y"], want["y"], atol=1e-3)
    np.testing.assert_allclose(got["size"], want["size"], atol=1e-5)
    np.testing.assert_allclose(got["response"], want["response"],
                               rtol=1e-4, atol=1e-6)
    # angles: matmul vs sequential accumulation can flip near-tie histogram
    # maxima for a rare keypoint; the rest must agree to float precision
    da = np.abs(got["angle"] - want["angle"])
    da = np.minimum(da, 2 * np.pi - da)
    assert (da < 1e-3).mean() > 0.97, f"angle agreement {(da < 1e-3).mean()}"
    # descriptors: compare bitwise with a small near-tie allowance
    gb = np.unpackbits(got["words"].view(np.uint8), axis=1)[:, :486]
    wb = np.unpackbits(want["words"].view(np.uint8), axis=1)[:, :486]
    per_kp = (gb != wb).sum(axis=1)
    same_angle = da < 1e-3
    assert per_kp[same_angle].mean() < 2.0, per_kp[same_angle].mean()
    assert np.median(per_kp[same_angle]) == 0


@pytest.mark.parametrize("fixed", [False, True])
def test_full_pipeline_matches_golden_192x256(base_image, fixed):
    img = base_image[300:492, 400:656]
    got = run_pipeline(img, fixed)
    want = run_golden(img, fixed)
    assert len(want["x"]) > 30  # the crop must actually exercise detection
    assert_parity(got, want, fixed)


def test_full_pipeline_matches_golden_160x208(base_image):
    """Second size: 2-octave layout (the <80px early stop kicks in)."""
    img = base_image[100:260, 500:708]
    got = run_pipeline(img, fixed=False)
    want = run_golden(img, fixed=False)
    assert len(want["x"]) > 15
    assert_parity(got, want, fixed=False)


@pytest.mark.slow
@pytest.mark.skipif(
    not __import__("os").environ.get("RUN_FULLRES"),
    reason="full-res oracle takes many minutes on one CPU; run "
           "explicitly with RUN_FULLRES=1")
def test_full_pipeline_matches_golden_960x1280(base_image):
    """The headline shape itself (960x1280) against the numpy oracle —
    full-res-only drift (e.g. tile-cap interactions at scale) is pinned
    here."""
    got = run_pipeline(base_image, fixed=False)
    want = run_golden(base_image, fixed=False)
    assert len(want["x"]) > 300
    assert_parity(got, want, fixed=False)
