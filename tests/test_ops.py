import numpy as np
import jax.numpy as jnp
import pytest

from akaze_jax.ops import (gauss_half_kernel, gauss_half_kernel_fixed,
                           sep_conv2d, sep_conv2d_fixed, down_with_smooth,
                           scharr_gradient_xy, scharr_magnitude,
                           scaled_derivatives, hessian_determinant,
                           nld_step, nld_step_fixed, conductivity,
                           percentile_contrast, percentile_contrast_fixed)
from akaze_jax.config import Diffusivity

import golden


@pytest.fixture(scope="module")
def img(rng=np.random.default_rng(7)):
    return rng.uniform(0, 1, (96, 133)).astype(np.float32)


def test_gauss_kernel_normalized():
    for var, r in ((1.0, 2), (2.56, 4), (1.0, 5)):
        k = np.asarray(gauss_half_kernel(var, r))
        assert abs(k[0] + 2 * k[1:].sum() - 1.0) < 1e-6
        ik = gauss_half_kernel_fixed(var, r)
        np.testing.assert_array_equal(
            ik, (k * 65536 + 0.5).astype(np.int64))


def test_sep_conv2d_matches_golden(img):
    for var, r in ((1.0, 2), (2.56, 4)):
        k = gauss_half_kernel(var, r)
        ours = np.asarray(sep_conv2d(jnp.asarray(img), k))
        ref = golden.sep_conv2d(img.astype(np.float64), np.asarray(k))
        np.testing.assert_allclose(ours, ref, atol=1e-5)


def test_sep_conv2d_fixed_matches_golden():
    rng = np.random.default_rng(3)
    x = rng.integers(0, 256, (64, 97)).astype(np.int32)
    ik = gauss_half_kernel_fixed(1.0, 2)
    ours = np.asarray(sep_conv2d_fixed(jnp.asarray(x), ik))
    ref = golden.sep_conv2d_fixed(x, np.asarray(ik, np.int64))
    np.testing.assert_array_equal(ours, ref)


def test_scharr_matches_golden(img):
    dx, dy = scharr_gradient_xy(jnp.asarray(img), 1)
    gdx, gdy = golden.scharr_xy(img.astype(np.float64), 1)
    np.testing.assert_allclose(np.asarray(dx), gdx, atol=1e-4)
    np.testing.assert_allclose(np.asarray(dy), gdy, atol=1e-4)
    mag = np.asarray(scharr_magnitude(jnp.asarray(img)))
    np.testing.assert_allclose(mag, np.sqrt(gdx**2 + gdy**2), atol=1e-4)


def test_scharr_dilated_step(img):
    # dilated sampling at step 3 against a manual golden
    dx, dy = scharr_gradient_xy(jnp.asarray(img), 3)
    gdx, gdy = golden.scharr_xy(img.astype(np.float64), 3)
    np.testing.assert_allclose(np.asarray(dx), gdx, atol=1e-4)
    np.testing.assert_allclose(np.asarray(dy), gdy, atol=1e-4)


def test_nld_step_matches_golden(img):
    rng = np.random.default_rng(5)
    flow = rng.uniform(0.2, 1.0, img.shape).astype(np.float32)
    ours = np.asarray(nld_step(jnp.asarray(img), jnp.asarray(flow), 0.1837))
    ref = golden.nld_step(img.astype(np.float64), flow.astype(np.float64),
                          0.1837)
    np.testing.assert_allclose(ours, ref, atol=1e-5)


def test_nld_step_fixed_shift_semantics():
    rng = np.random.default_rng(6)
    img = rng.integers(0, 256, (48, 64)).astype(np.int32)
    flow = rng.integers(0, 65537, (48, 64)).astype(np.int32)
    tau = 0.1837
    ours = np.asarray(nld_step_fixed(jnp.asarray(img), jnp.asarray(flow),
                                     tau))
    # golden: int64 to avoid surprise overflow, then exact shifts
    i64, f64 = img.astype(np.int64), flow.astype(np.int64)
    h, w = img.shape
    ridx = golden.reflect_idx
    up = ridx(np.arange(h) - 1, h); dn = ridx(np.arange(h) + 1, h)
    lf = ridx(np.arange(w) - 1, w); rt = ridx(np.arange(w) + 1, w)
    step = ((f64 + f64[:, rt]) * (i64[:, rt] - i64)
            + (f64 + f64[:, lf]) * (i64[:, lf] - i64)
            + (f64 + f64[dn, :]) * (i64[dn, :] - i64)
            + (f64 + f64[up, :]) * (i64[up, :] - i64)) >> 16
    stepfac = int(0.5 * tau * 65536 + 0.5)
    ref = ((stepfac * step) >> 16) + i64
    np.testing.assert_array_equal(ours, ref)


def test_percentile_contrast_matches_golden(img):
    mag = np.asarray(scharr_magnitude(jnp.asarray(img)))
    ours = float(percentile_contrast(jnp.asarray(mag), 0.7))
    ref = float(golden.percentile_contrast(mag, 0.7))
    assert abs(ours - ref) < 1e-6


def test_down_with_smooth_decimation(img):
    dst, smooth = down_with_smooth(jnp.asarray(img))
    np.testing.assert_array_equal(np.asarray(dst), img[0:96:2, 0:132:2])
    # smoothed decimation approximates a blur of the decimated image
    assert np.asarray(smooth).shape == (48, 66)
    assert abs(np.asarray(smooth).mean() - img[0:96:2, 0:132:2].mean()) < 0.01


def test_conductivity_types(img):
    kc = jnp.float32(0.5)
    for d in Diffusivity:
        g = np.asarray(conductivity(jnp.asarray(img), d, kc))
        assert np.all(g >= 0) and np.all(g <= 1.0 + 1e-6)
    # PM_G2 closed form
    dx, dy = golden.scharr_xy(img.astype(np.float64), 1)
    expect = 1.0 / (1.0 + (dx**2 + dy**2) / 0.25)
    got = np.asarray(conductivity(jnp.asarray(img), Diffusivity.PM_G2, kc))
    np.testing.assert_allclose(got, expect, rtol=1e-4)


def test_percentile_contrast_fixed_int_semantics():
    rng = np.random.default_rng(9)
    grad = rng.integers(0, 5000, (64, 80)).astype(np.int32)
    ours = int(percentile_contrast_fixed(jnp.asarray(grad), 0.7))
    mx = max(1, grad.max())
    hf = int(300 / np.float32(mx) * 65536 + 0.5)
    bins = np.clip((grad.astype(np.int64) * hf) >> 16, 0, 299)
    hist = np.bincount(bins.ravel(), minlength=300)
    thresh = int((grad.size - hist[0]) * 0.7)
    cum, k = 0, 1
    while k < 300:
        if cum >= thresh:
            break
        cum += hist[k]
        k += 1
    assert ours == k * mx // 300
