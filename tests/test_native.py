"""Tests for the C++ native host runtime (compiled on the fly with g++)."""


import numpy as np
import pytest

from akaze_jax.native import (get_lib, fed_tau_native, load_pgm_native,
                              FrameLoader, hamming_match_native)
from akaze_jax.fed import fed_tau_by_process_time


needs_native = pytest.mark.skipif(get_lib() is None,
                                  reason="native toolchain unavailable")


@needs_native
class TestNativeFed:
    def test_matches_python_planner(self):
        for t, reorder in [(0.5, True), (0.5, False), (2.3, True),
                           (0.08, True)]:
            py = np.asarray(fed_tau_by_process_time(t, 1, 0.25, reorder),
                            np.float32)
            nat = fed_tau_native(t, 0.25, reorder)
            assert nat is not None
            assert len(nat) == len(py)
            # same cycle time and same step multiset
            np.testing.assert_allclose(nat.sum(), py.sum(), rtol=1e-5)
            np.testing.assert_allclose(np.sort(nat), np.sort(py),
                                       rtol=1e-4)
            if reorder and len(py) > 2:
                np.testing.assert_allclose(nat, py, rtol=1e-4)


@needs_native
class TestNativePgm:
    def test_decode_matches_python(self, tmp_path, stereo_pair):
        from akaze_jax.io import load_pgm, save_pgm
        ref = str(tmp_path / "left.pgm")
        save_pgm(ref, stereo_pair[0])
        a = load_pgm(ref)
        b = load_pgm_native(ref)
        np.testing.assert_array_equal(a, stereo_pair[0])
        np.testing.assert_array_equal(a, b)

    def test_decode_synthetic(self, tmp_path, rng):
        img = rng.integers(0, 256, (17, 23), dtype=np.uint8)
        p = str(tmp_path / "x.pgm")
        with open(p, "wb") as f:
            f.write(b"P5\n# comment\n23 17\n255\n")
            f.write(img.tobytes())
        out = load_pgm_native(p)
        np.testing.assert_array_equal(out, img)


@needs_native
class TestFrameLoader:
    def test_in_order_delivery(self, tmp_path, rng):
        paths = []
        imgs = []
        for i in range(8):
            img = rng.integers(0, 256, (11, 13), dtype=np.uint8)
            p = str(tmp_path / f"f{i}.pgm")
            with open(p, "wb") as f:
                f.write(b"P5\n13 11\n255\n" + img.tobytes())
            paths.append(p)
            imgs.append(img)
        loader = FrameLoader(paths, n_threads=3, prefetch=2)
        got = list(loader)
        loader.close()
        assert len(got) == 8
        for a, b in zip(got, imgs):
            np.testing.assert_array_equal(a, b)


@needs_native
class TestNativeMatch:
    def test_matches_jax_matcher(self, rng):
        import jax.numpy as jnp
        from akaze_jax.match import match
        n1, n2 = 64, 96
        w1 = rng.integers(0, 2 ** 32, (n1, 16), dtype=np.uint64).astype(
            np.uint32)
        w2 = rng.integers(0, 2 ** 32, (n2, 16), dtype=np.uint64).astype(
            np.uint32)
        # zero the pad bits (>486) like the real descriptors do
        w1[:, 15] &= np.uint32((1 << 6) - 1)
        w2[:, 15] &= np.uint32((1 << 6) - 1)
        # plant exact correspondences so some matches pass max_dist
        w2[10] = w1[3]
        w2[20] = w1[7]
        idx_n, dist_n = hamming_match_native(w1, w2, 96)
        m = match(jnp.asarray(w1), jnp.ones(n1, bool), jnp.asarray(w2),
                  jnp.ones(n2, bool), jnp.zeros(n2), jnp.zeros(n2), 96)
        np.testing.assert_array_equal(idx_n, np.asarray(m.index))
        accepted = idx_n >= 0
        np.testing.assert_array_equal(
            dist_n[accepted], np.asarray(m.distance)[accepted].astype(
                np.int32))
        assert idx_n[3] == 10 and idx_n[7] == 20


@needs_native
class TestFrameLoaderDeadlock:
    def test_more_threads_than_capacity(self, tmp_path, rng):
        """Regression: with workers > queue capacity, the old size-based
        admission could fill the queue with out-of-order frames and
        deadlock the in-order consumer."""
        paths = []
        imgs = []
        for i in range(16):
            img = rng.integers(0, 256, (9, 11), dtype=np.uint8)
            p = str(tmp_path / f"f{i}.pgm")
            with open(p, "wb") as f:
                f.write(b"P5\n11 9\n255\n" + img.tobytes())
            paths.append(p)
            imgs.append(img)
        # worst case: capacity 1, many workers
        for _ in range(3):
            loader = FrameLoader(paths, n_threads=4, prefetch=1)
            got = list(loader)
            loader.close()
            assert len(got) == 16
            for a, b in zip(got, imgs):
                np.testing.assert_array_equal(a, b)

    def test_early_close_joins_workers(self, tmp_path, rng):
        """Destroying the loader mid-stream must not hang."""
        paths = []
        for i in range(8):
            img = rng.integers(0, 256, (9, 11), dtype=np.uint8)
            p = str(tmp_path / f"g{i}.pgm")
            with open(p, "wb") as f:
                f.write(b"P5\n11 9\n255\n" + img.tobytes())
            paths.append(p)
        loader = FrameLoader(paths, n_threads=3, prefetch=2)
        next(loader)   # consume one frame only
        loader.close()  # must join all workers promptly
