"""Tests for host-side rendering and PNG IO."""

import numpy as np

from akaze_jax.viz import (draw_keypoints, draw_matches, write_png, read_png,
                           to_rgb)


class TestPng:
    def test_roundtrip_gray(self, tmp_path, rng):
        img = rng.integers(0, 256, (37, 53), dtype=np.uint8)
        p = str(tmp_path / "g.png")
        write_png(p, img)
        back = read_png(p)
        np.testing.assert_array_equal(back, img)

    def test_roundtrip_rgb(self, tmp_path, rng):
        img = rng.integers(0, 256, (24, 31, 3), dtype=np.uint8)
        p = str(tmp_path / "c.png")
        write_png(p, img)
        back = read_png(p)
        np.testing.assert_array_equal(back, img)


class TestDraw:
    def test_draw_keypoints_marks_pixels(self):
        gray = np.zeros((64, 64), np.uint8)
        img = draw_keypoints(gray, [32.0], [32.0], [5.0])
        assert img.shape == (64, 64, 3)
        assert (img != 0).any()
        # circle of radius 5 around center: pixel at (32, 37) colored
        assert tuple(img[32, 37]) != (0, 0, 0)
        assert tuple(img[32, 32]) == (0, 0, 0)  # center untouched

    def test_draw_matches_line(self):
        g1 = np.zeros((32, 32), np.uint8)
        g2 = np.zeros((32, 32), np.uint8)
        img = draw_matches(g1, g2, [5.0], [5.0], [10.0], [10.0], [True])
        assert img.shape == (32, 64, 3)
        assert (img != 0).any()

    def test_to_rgb_float(self):
        g = np.linspace(0, 1, 16).reshape(4, 4).astype(np.float32)
        rgb = to_rgb(g)
        assert rgb.dtype == np.uint8
        assert rgb[3, 3, 0] == 255
