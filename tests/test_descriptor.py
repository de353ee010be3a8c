import math

import pytest

import numpy as np
import jax.numpy as jnp

from akaze_jax import AkazeConfig
from akaze_jax.descriptor import (_compare_indices, _descriptor_window,
                                  _orient_grid, descriptors_to_bytes,
                                  fast_atan2)
from akaze_jax.config import DESCRIPTOR_BITS


def test_compare_indices_structure():
    i1, i2 = _compare_indices()
    assert len(i1) == DESCRIPTOR_BITS == 486
    # block sizes: 3 channels x C(4,2), C(9,2), C(16,2)
    assert np.all(i1 < i2)
    # channel of both ends of each pair must agree
    assert np.array_equal(i1 % 3, i2 % 3)
    cells1, cells2 = i1 // 3, i2 // 3
    # 2x2 pairs first (cells 0..3), then 3x3 (4..12), then 4x4 (13..28)
    assert cells1[:18].max() < 4 and cells2[:18].max() < 4
    assert cells1[18:126].min() >= 4 and cells2[18:126].max() < 13
    assert cells1[126:].min() >= 13 and cells2[126:].max() < 29
    # pairs unique
    assert len({(a, b) for a, b in zip(i1, i2)}) == 486


def test_descriptor_window_tables():
    l, k, M = _descriptor_window(10)
    assert len(l) == 21 * 21
    # every sample contributes to the 3x3 grid (m < 21 always)
    assert (M[:, 4:13].sum(axis=1) == 1).all()
    # cell populations: 2x2 cells get 100 samples each (20x20 / 4)
    assert M[:, 0].sum() == 100
    # 4x4 cells get 25 each (20x20 / 16)
    assert M[:, 13].sum() == 25
    # 3x3: 21x21 / 9 = 49
    assert M[:, 4].sum() == 49


def test_orient_grid_disc():
    wt = _orient_grid()
    assert (wt > 0).sum() == 109  # the reference's 109-tap disc
    assert wt[5, 5] == 1.0        # center weight exp(0)
    # symmetric
    np.testing.assert_allclose(wt, wt[::-1, :])
    np.testing.assert_allclose(wt, wt[:, ::-1])


def test_fast_atan2_accuracy():
    ang = np.linspace(-math.pi, math.pi, 721)[:-1]
    y = np.sin(ang).astype(np.float32)
    x = np.cos(ang).astype(np.float32)
    got = np.asarray(fast_atan2(jnp.asarray(y), jnp.asarray(x)))
    ref = np.arctan2(y, x)
    assert np.abs(got - ref).max() < 0.01  # the polynomial's design accuracy


def test_descriptors_to_bytes_roundtrip():
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, (5, 486)).astype(np.uint8)
    padded = np.zeros((5, 512), np.uint8)
    padded[:, :486] = bits
    words = np.packbits(padded, axis=1, bitorder="little").view(np.uint32)
    by = descriptors_to_bytes(words)
    assert by.shape == (5, 61)
    unpacked = np.unpackbits(by, axis=1, bitorder="little")[:, :486]
    np.testing.assert_array_equal(unpacked, bits)


@pytest.mark.parametrize("fixed", [False, True])
def test_orient_describe_match_golden(fixed):
    """The gather-form orientation and MLDB descriptor against the numpy
    oracle (golden_pipeline.orient_golden / describe_golden) on the SAME
    planes and keypoints, so only these two stages are compared.  The
    samples are exact reads; the oracle sums cells sequentially while the
    pipeline takes one float32 product, so a rare near-tie comparison may
    flip."""
    import jax
    from akaze_jax.descriptor import compute_descriptors, compute_orientation
    from akaze_jax.detect import detect_keypoints, flatten_pyramid
    from akaze_jax.plan import build_plan
    from akaze_jax.scale_space import build_scale_space
    from akaze_jax.io import textured_image
    from golden_pipeline import describe_golden, orient_golden

    img = textured_image((192, 256), seed=1)
    img = img.astype(np.int32) if fixed else img.astype(np.float32) / 255
    plan = build_plan(*img.shape, AkazeConfig(max_pts=512))

    @jax.jit
    def run(im):
        octs, _ = build_scale_space(im, plan, fixed)
        kps = detect_keypoints(octs, plan, fixed)
        flat = flatten_pyramid(octs)
        angle = compute_orientation(kps, flat, plan, fixed)
        return octs, kps, angle, compute_descriptors(kps, angle, flat, plan,
                                                     fixed).words

    octs, kps, angle, words = run(jnp.asarray(img))
    n = int(kps.count)
    assert n > 30
    gocts = [{k: np.asarray(getattr(o, k)) for k in ("L", "lx", "ly")}
             for o in octs]
    angle = np.asarray(angle)
    words = np.asarray(words)
    ga, flips = [], []
    for i in range(n):
        kp = {k: np.asarray(getattr(kps, k))[i]
              for k in ("x", "y", "size", "layer")}
        ga.append(orient_golden(kp, gocts, plan.config.max_scale, fixed))
        bits = describe_golden(kp, angle[i], gocts, plan.config.max_scale,
                               fixed=fixed)
        got = np.unpackbits(words[i].view(np.uint8), bitorder="little")
        flips.append(int((got[:486] != bits).sum()))
    da = np.abs(angle[:n] - np.asarray(ga))
    da = np.minimum(da, 2 * np.pi - da)
    assert (da < 1e-4).mean() > 0.97, (da < 1e-4).mean()
    flips = np.asarray(flips)
    assert np.median(flips) == 0 and flips.mean() < 1.0, flips.mean()
    # dead slots carry zero words and angles
    assert not words[n:].any() and not angle[n:].any()
