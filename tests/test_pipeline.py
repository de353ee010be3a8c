import numpy as np
import pytest

from akaze_jax import Akaze, AkazeConfig
from akaze_jax.pipeline import features_to_numpy


@pytest.fixture(scope="module")
def crops(stereo_pair):
    L, _ = stereo_pair
    return L[100:356, 200:520], L[107:363, 213:533]  # offset (7, 13)


@pytest.mark.parametrize("fixed", [False, True])
def test_known_shift_matching(crops, fixed):
    A, B = crops
    det = Akaze(AkazeConfig(max_pts=4000), fixed=fixed)
    fa = det.detect_and_compute(A if fixed else A.astype(np.float32) / 255)
    fb = det.detect_and_compute(B if fixed else B.astype(np.float32) / 255)
    n = int(fa.count)
    assert n > 50
    m = det.match(fa, fb)
    idx = np.asarray(m.index[:n])
    acc = idx >= 0
    assert acc.sum() > 0.5 * n
    dx = np.asarray(m.match_x[:n])[acc] - np.asarray(fa.x[:n])[acc]
    dy = np.asarray(m.match_y[:n])[acc] - np.asarray(fa.y[:n])[acc]
    good = (np.abs(dx + 13) < 1.5) & (np.abs(dy + 7) < 1.5)
    assert good.mean() > 0.8
    assert abs(np.median(dx) + 13) < 0.5
    assert abs(np.median(dy) + 7) < 0.5


def test_keypoint_fields_sane(crops):
    A, _ = crops
    det = Akaze(AkazeConfig(max_pts=4000))
    f = det.detect_and_compute(A.astype(np.float32) / 255)
    d = features_to_numpy(f)
    n = d["count"]
    assert n > 0
    h, w = A.shape
    assert (d["x"] >= 0).all() and (d["x"] < w).all()
    assert (d["y"] >= 0).all() and (d["y"] < h).all()
    assert (d["angle"] >= 0).all() and (d["angle"] < 2 * np.pi + 1e-5).all()
    assert (d["response"] > 0).all()
    assert set(np.unique(d["layer"])) <= set(range(16))
    assert d["valid"].all()


def test_determinism(crops):
    A, _ = crops
    det = Akaze(AkazeConfig(max_pts=2000))
    f1 = det.detect_and_compute(A.astype(np.float32) / 255)
    f2 = det.detect_and_compute(A.astype(np.float32) / 255)
    np.testing.assert_array_equal(np.asarray(f1.x), np.asarray(f2.x))
    np.testing.assert_array_equal(np.asarray(f1.words), np.asarray(f2.words))


def test_flat_image_no_keypoints():
    det = Akaze(AkazeConfig(max_pts=256))
    f = det.detect_and_compute(np.full((160, 160), 0.5, np.float32))
    assert int(f.count) == 0
    m = det.match(f, f)
    assert (np.asarray(m.index) == -1).all()


def test_max_pts_cap():
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 1, (256, 256)).astype(np.float32)
    det = Akaze(AkazeConfig(max_pts=32))
    f = det.detect_and_compute(img)
    assert int(f.count) <= 32
    assert np.asarray(f.valid).sum() == int(f.count)


class TestExports:
    def test_features_to_numpy_trims_to_count(self, test_image):
        import jax.numpy as jnp
        from akaze_jax import AkazeConfig
        from akaze_jax.plan import build_plan
        from akaze_jax.pipeline import detect_and_compute, features_to_numpy
        cfg = AkazeConfig(max_pts=256, noctaves=2)
        plan = build_plan(*test_image.shape, cfg)
        f = detect_and_compute(jnp.asarray(test_image), plan)
        d = features_to_numpy(f)
        n = d["count"]
        assert 0 < n <= 256
        assert d["x"].shape == (n,)
        assert d["words"].shape == (n, 16)
        assert d["valid"].all()

    def test_descriptors_to_bytes_layout(self, rng):
        from akaze_jax.descriptor import descriptors_to_bytes
        words = rng.integers(0, 2**32, (5, 16), dtype=np.uint64).astype(
            np.uint32)
        b = descriptors_to_bytes(words)
        assert b.shape == (5, 61)
        # byte 0 holds bits 0-7 of word 0 (little-endian)
        assert b[0, 0] == (int(words[0, 0]) & 0xFF)
        assert b[0, 4] == (int(words[0, 1]) & 0xFF)

    def test_config_validation(self):
        import pytest as _pytest
        from akaze_jax import AkazeConfig
        with _pytest.raises(ValueError):
            AkazeConfig(max_scale=9)
        with _pytest.raises(ValueError):
            AkazeConfig(noctaves=0)
        with _pytest.raises(ValueError):
            AkazeConfig(max_scale=0)
