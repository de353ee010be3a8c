"""Tests for the two-view geometry stack (se3, epipolar, ransac)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from akaze_jax.geometry import (se3_exp, se3_log, se3_inverse, se3_compose,
                                se3_apply, so3_exp, so3_log,
                                essential_from_eight, decompose_essential,
                                triangulate, sampson_error, recover_pose,
                                ransac_essential)
from akaze_jax.geometry.se3 import hat


def random_rotation(rng):
    w = rng.standard_normal(3)
    w = w / np.linalg.norm(w) * rng.uniform(0.1, 2.9)
    return np.asarray(so3_exp(jnp.asarray(w, jnp.float32)))


class TestSE3:
    def test_so3_exp_log_roundtrip(self, rng):
        w = rng.standard_normal((64, 3)).astype(np.float32)
        w *= (rng.uniform(0.01, 3.0, (64, 1)) /
              np.linalg.norm(w, axis=1, keepdims=True)).astype(np.float32)
        R = so3_exp(jnp.asarray(w))
        w2 = so3_log(R)
        np.testing.assert_allclose(np.asarray(w2), w, atol=2e-4)

    def test_so3_orthonormal(self, rng):
        w = rng.standard_normal((16, 3)).astype(np.float32)
        R = np.asarray(so3_exp(jnp.asarray(w)))
        eye = np.einsum("bij,bkj->bik", R, R)
        np.testing.assert_allclose(eye, np.tile(np.eye(3), (16, 1, 1)),
                                   atol=1e-5)
        np.testing.assert_allclose(np.linalg.det(R), 1.0, atol=1e-5)

    def test_se3_exp_log_roundtrip(self, rng):
        xi = rng.standard_normal((32, 6)).astype(np.float32) * 0.8
        R, t = se3_exp(jnp.asarray(xi))
        xi2 = se3_log(R, t)
        np.testing.assert_allclose(np.asarray(xi2), xi, atol=3e-4)

    def test_se3_inverse_compose(self, rng):
        xi = rng.standard_normal((8, 6)).astype(np.float32)
        R, t = se3_exp(jnp.asarray(xi))
        Ri, ti = se3_inverse(R, t)
        Rc, tc = se3_compose(R, t, Ri, ti)
        np.testing.assert_allclose(np.asarray(Rc),
                                   np.tile(np.eye(3), (8, 1, 1)), atol=1e-5)
        np.testing.assert_allclose(np.asarray(tc), 0.0, atol=1e-5)

    def test_se3_apply(self, rng):
        xi = rng.standard_normal(6).astype(np.float32)
        R, t = se3_exp(jnp.asarray(xi))
        p = rng.standard_normal((10, 3)).astype(np.float32)
        q = se3_apply(R, t, jnp.asarray(p))
        np.testing.assert_allclose(np.asarray(q),
                                   p @ np.asarray(R).T + np.asarray(t),
                                   atol=1e-5)


def make_two_view(rng, n=100, noise=0.0, outlier_frac=0.0):
    """Synthetic calibrated two-view problem; returns x1, x2, (R, t), X."""
    X = rng.uniform([-2, -2, 4], [2, 2, 10], (n, 3)).astype(np.float64)
    R = random_rotation(rng).astype(np.float64)
    # moderate rotation looking roughly at the points
    w = rng.standard_normal(3)
    w *= 0.15 / np.linalg.norm(w)
    R = np.asarray(so3_exp(jnp.asarray(w, jnp.float32))).astype(np.float64)
    t = rng.uniform(-1, 1, 3)
    t[2] *= 0.2
    t *= 1.0 / max(np.linalg.norm(t), 0.3)  # well-conditioned baseline
    X2 = X @ R.T + t
    x1 = X[:, :2] / X[:, 2:3]
    x2 = X2[:, :2] / X2[:, 2:3]
    if noise:
        x1 += rng.standard_normal(x1.shape) * noise
        x2 += rng.standard_normal(x2.shape) * noise
    n_out = int(n * outlier_frac)
    if n_out:
        pick = rng.choice(n, n_out, replace=False)
        x2[pick] = rng.uniform(-0.5, 0.5, (n_out, 2))
    return (x1.astype(np.float32), x2.astype(np.float32),
            R.astype(np.float32), t.astype(np.float32), X.astype(np.float32))


class TestEpipolar:
    def test_eight_point_exact(self, rng):
        x1, x2, R, t, X = make_two_view(rng, n=60)
        E = essential_from_eight(jnp.asarray(x1), jnp.asarray(x2))
        err = np.asarray(sampson_error(E, jnp.asarray(x1), jnp.asarray(x2)))
        assert np.median(err) < 1e-8

        # E ~ [t]x R up to scale
        E_true = np.asarray(hat(jnp.asarray(t))) @ R
        E_true /= np.linalg.norm(E_true)
        E_np = np.asarray(E) / np.linalg.norm(np.asarray(E))
        align = abs(np.sum(E_true * E_np))
        assert align > 0.999

    @pytest.mark.parametrize("seed", [0, 1])
    def test_eight_point_matches_float64(self, seed):
        """The f32 solve against a float64 SVD of the same constraint rows,
        with 0.3 px noise at f = 600: the N-point (refit) form and the
        median 8-point minimal sample.  The null vector of eigh(A^T A) in
        f32 was off by ~1e-4 and ~5e-2 here."""
        rng = np.random.default_rng(seed)
        x1, x2, *_ = make_two_view(rng, n=80, noise=0.3 / 600)

        def f64(a, b):
            h1 = np.concatenate([a, np.ones_like(a[..., :1])], -1)
            h2 = np.concatenate([b, np.ones_like(b[..., :1])], -1)
            A = (h2[..., :, :, None].astype(np.float64)
                 * h1[..., None, :]).reshape(a.shape[:-1] + (9,))
            if A.shape[-2] < 9:
                A = np.concatenate([A, np.zeros(A.shape[:-2] + (1, 9))], -2)
            E = np.linalg.svd(A)[2][..., -1, :].reshape(a.shape[:-2] + (3, 3))
            U, _, Vt = np.linalg.svd(E)
            return U @ np.diag([1.0, 1.0, 0.0]) @ Vt

        def dist(Ea, Eb):       # E is defined up to sign
            Ea = Ea / np.linalg.norm(Ea, axis=(-2, -1), keepdims=True)
            Eb = Eb / np.linalg.norm(Eb, axis=(-2, -1), keepdims=True)
            return np.minimum(np.linalg.norm(Ea - Eb, axis=(-2, -1)),
                              np.linalg.norm(Ea + Eb, axis=(-2, -1)))

        E = essential_from_eight(jnp.asarray(x1), jnp.asarray(x2))
        assert dist(np.asarray(E), f64(x1, x2)) < 1e-5
        idx = rng.integers(0, len(x1), (256, 8))
        Em = essential_from_eight(jnp.asarray(x1[idx]), jnp.asarray(x2[idx]))
        assert np.median(dist(np.asarray(Em), f64(x1[idx], x2[idx]))) < 1e-3

    def test_essential_singular_values(self, rng):
        x1, x2, *_ = make_two_view(rng, n=30)
        E = np.asarray(essential_from_eight(jnp.asarray(x1),
                                            jnp.asarray(x2)))
        s = np.linalg.svd(E, compute_uv=False)
        np.testing.assert_allclose(s[0], s[1], atol=1e-5)
        assert s[2] < 1e-6

    def test_decompose_recover(self, rng):
        x1, x2, R, t, X = make_two_view(rng, n=80)
        E = essential_from_eight(jnp.asarray(x1), jnp.asarray(x2))
        R_est, t_est, good = recover_pose(E, jnp.asarray(x1),
                                          jnp.asarray(x2))
        assert int(np.sum(np.asarray(good))) > 70
        np.testing.assert_allclose(np.asarray(R_est), R, atol=1e-3)
        t_unit = t / np.linalg.norm(t)
        np.testing.assert_allclose(np.asarray(t_est), t_unit, atol=1e-3)

    def test_triangulate(self, rng):
        x1, x2, R, t, X = make_two_view(rng, n=50)
        Xh, z1, z2 = triangulate(jnp.asarray(R), jnp.asarray(t),
                                 jnp.asarray(x1), jnp.asarray(x2))
        np.testing.assert_allclose(np.asarray(Xh), X, rtol=2e-3, atol=2e-3)
        assert np.all(np.asarray(z1) > 0)
        assert np.all(np.asarray(z2) > 0)


class TestRansac:
    def test_ransac_with_outliers(self, rng):
        x1, x2, R, t, X = make_two_view(rng, n=200, noise=5e-4,
                                        outlier_frac=0.35)
        key = jax.random.PRNGKey(3)
        # 512 hypotheses: at 35% outliers a 256-draw budget occasionally
        # tops out in a 126-inlier basin (errR ~0.06) on some (data, key)
        # pairs — ordinary RANSAC sampling variance, measured when the rng
        # fixture became per-test
        res = ransac_essential(key, jnp.asarray(x1), jnp.asarray(x2),
                               jnp.ones(200, bool), threshold=5e-5,
                               num_hyps=512)
        n_inl = int(res.num_inliers)
        assert n_inl > 100
        np.testing.assert_allclose(np.asarray(res.R), R, atol=0.02)
        t_unit = t / np.linalg.norm(t)
        cos = abs(float(np.dot(np.asarray(res.t), t_unit)))
        assert cos > 0.99

    def test_ransac_respects_valid_mask(self, rng):
        x1, x2, R, t, X = make_two_view(rng, n=100, noise=1e-4)
        # poison masked-out rows with garbage
        x2_bad = x2.copy()
        x2_bad[50:] = rng.uniform(-1, 1, (50, 2)).astype(np.float32)
        valid = np.zeros(100, bool)
        valid[:50] = True
        res = ransac_essential(jax.random.PRNGKey(0), jnp.asarray(x1),
                               jnp.asarray(x2_bad), jnp.asarray(valid),
                               threshold=5e-5, num_hyps=256)
        inl = np.asarray(res.inliers)
        assert not inl[50:].any()
        assert inl[:50].sum() > 35


class TestHomography:
    def test_exact_recovery(self, rng):
        from akaze_jax.geometry.homography import (homography_from_points,
                                                   homography_transfer_error)
        H_true = np.asarray([[1.1, 0.05, 3.0], [-0.04, 0.95, -2.0],
                             [1e-4, -2e-4, 1.0]])
        x1 = rng.uniform(0, 100, (40, 2))
        h = np.concatenate([x1, np.ones((40, 1))], 1) @ H_true.T
        x2 = h[:, :2] / h[:, 2:3]
        H = homography_from_points(jnp.asarray(x1, jnp.float32),
                                   jnp.asarray(x2, jnp.float32))
        err = np.asarray(homography_transfer_error(
            H, jnp.asarray(x1, jnp.float32), jnp.asarray(x2, jnp.float32)))
        assert np.median(err) < 1e-3  # squared px

    def test_ransac_with_outliers(self, rng):
        from akaze_jax.geometry.homography import ransac_homography
        H_true = np.asarray([[0.9, 0.1, 5.0], [-0.1, 1.05, 2.0],
                             [2e-4, 1e-4, 1.0]])
        n = 150
        x1 = rng.uniform(0, 200, (n, 2))
        h = np.concatenate([x1, np.ones((n, 1))], 1) @ H_true.T
        x2 = h[:, :2] / h[:, 2:3]
        x2 += rng.standard_normal((n, 2)) * 0.3
        out = rng.choice(n, 50, replace=False)
        x2[out] = rng.uniform(0, 200, (50, 2))
        res = ransac_homography(jax.random.PRNGKey(1),
                                jnp.asarray(x1, jnp.float32),
                                jnp.asarray(x2, jnp.float32),
                                jnp.ones(n, bool), threshold=4.0,
                                num_hyps=256)
        inl = np.asarray(res.inliers)
        assert int(res.num_inliers) > 85
        assert inl[out].sum() < 5  # planted outliers rejected


class TestPnP:
    def test_dlt_pnp_recovers_pose(self, rng):
        from akaze_jax.geometry.homography import pnp_dlt
        X, words = None, None
        Xw = rng.uniform([-2, -2, 4], [2, 2, 10], (30, 3)).astype(np.float32)
        R_true = random_rotation(rng)
        t_true = np.asarray([0.3, -0.2, 0.5], np.float32)
        # ensure points are in front of the camera
        Xc = Xw @ R_true.T + t_true
        if (Xc[:, 2] <= 0.1).any():
            t_true = t_true + np.asarray([0, 0, 12], np.float32)
            Xc = Xw @ R_true.T + t_true
        u = Xc[:, :2] / Xc[:, 2:3]
        R, t = pnp_dlt(jnp.asarray(Xw), jnp.asarray(u, jnp.float32))
        np.testing.assert_allclose(np.asarray(R), R_true, atol=1e-3)
        np.testing.assert_allclose(np.asarray(t), t_true, atol=1e-2)


def test_solvers_trace_f32_products_at_highest_precision():
    """The jitted back-end solvers run every f32 matrix product at
    Precision.HIGHEST (on a GPU the default may be TF32)."""
    import re
    from akaze_jax.geometry import ransac_essential

    x = jnp.zeros((16, 2), jnp.float32)
    jaxpr = str(jax.make_jaxpr(ransac_essential)(
        jax.random.PRNGKey(0), x, x, jnp.ones(16, bool)))
    dots = re.findall(r"dot_general\[(.*?)\n\s*\]", jaxpr, re.S)
    assert dots and all("HIGHEST" in d for d in dots), dots[:2]
    plain = str(jax.make_jaxpr(lambda a, b: a @ b)(jnp.ones((3, 3)),
                                                   jnp.ones((3, 3))))
    assert "HIGHEST" not in plain
