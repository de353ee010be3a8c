"""Batched loop closure: signature prefilter + one-dispatch candidate
matching over a keyframe store with K >= 20 keyframes."""

import numpy as np
import jax.numpy as jnp
import pytest

from akaze_jax.slam.odometry import Intrinsics, Keyframe
from akaze_jax.slam.system import SlamSystem, SlamConfig, KeyframeIndex
from akaze_jax.slam.posegraph import _edge_residuals, PoseGraph
from test_odometry import synth_features, project_features, INTR


def build_looped_system(rng, n_kf=24):
    """A SlamSystem preloaded with n_kf synthetic keyframes: each keyframe
    sees its own landmark field EXCEPT the last, which revisits keyframe
    0's landmarks from a nearby pose (a true loop)."""
    sys_ = SlamSystem(INTR, slam_config=SlamConfig(
        min_loop_gap=5, loop_min_matches=40, loop_min_inliers=30,
        loop_candidates=4))
    X0, words0 = synth_features(rng, n_pts=80)
    R_loop = np.eye(3, dtype=np.float32)
    t_loop = np.asarray([0.45, 0.0, 0.02], np.float32)

    for k in range(n_kf):
        if k == 0:
            X, words = X0, words0
            R = np.eye(3, dtype=np.float32)
            t = np.zeros(3, np.float32)
        elif k == n_kf - 1:
            X, words = X0, words0      # revisit
            R, t = R_loop, t_loop
        else:
            X, words = synth_features(rng, n_pts=80)
            R = np.eye(3, dtype=np.float32)
            t = np.asarray([5.0 * k, 0.0, 0.0], np.float32)
        feats = project_features(X, words, R, t)
        sys_.vo.keyframes.append(Keyframe(k, feats, R, t))
        sys_.index.add(feats)
    return sys_


class TestKeyframeIndex:
    def test_signature_prefers_revisited_keyframe(self, rng):
        idx = KeyframeIndex()
        X0, words0 = synth_features(rng, n_pts=80)
        for k in range(21):
            if k in (0, 20):
                X, words = X0, words0
            else:
                X, words = synth_features(rng, n_pts=80)
            idx.add(project_features(X, words, np.eye(3, dtype=np.float32),
                                     np.zeros(3, np.float32)))
        cand = idx.candidates(20, gap=5, top=4)
        assert len(cand) == 4
        assert cand[0] == 0  # identical descriptor set ranks first

    def test_match_counts_one_dispatch_shape(self, rng):
        idx = KeyframeIndex()
        X0, words0 = synth_features(rng, n_pts=60)
        for k in range(8):
            X, words = (X0, words0) if k in (0, 7) else \
                synth_features(rng, n_pts=60)
            idx.add(project_features(X, words, np.eye(3, dtype=np.float32),
                                     np.zeros(3, np.float32)))
        cand = np.asarray([0, 3, 5])
        counts = idx.match_counts(7, cand)
        assert counts.shape == (3,)
        assert counts[0] >= 50          # revisited: nearly all match
        assert counts[1] < 10 and counts[2] < 10

    def test_empty_candidates(self, rng):
        idx = KeyframeIndex()
        X, words = synth_features(rng, n_pts=40)
        idx.add(project_features(X, words, np.eye(3, dtype=np.float32),
                                 np.zeros(3, np.float32)))
        assert len(idx.candidates(0, gap=5, top=4)) == 0
        assert len(idx.match_counts(0, np.empty(0, np.int64))) == 0


class TestBatchedLoopClosure:
    def test_loop_detected_with_20_plus_keyframes(self, rng):
        sys_ = build_looped_system(rng, n_kf=24)
        sys_._try_loop_closure(23)
        loops = [e for e in sys_.edges]
        assert len(loops) >= 1
        pairs = {(e[0], e[1]) for e in loops}
        assert (23, 0) in pairs
        # no spurious loop edges to unrelated keyframes
        assert all(j == 0 for (_, j) in pairs)

        # edge-frame convention: residual ~0 for the consistent poses
        e = [e for e in loops if (e[0], e[1]) == (23, 0)][0]
        kfs = sys_.vo.keyframes
        g = PoseGraph(i=jnp.asarray([0], jnp.int32),
                      j=jnp.asarray([1], jnp.int32),
                      R_ij=jnp.asarray(e[2])[None],
                      t_ij=jnp.asarray(e[3])[None],
                      weight=jnp.ones(1, jnp.float32))
        r = np.asarray(_edge_residuals(
            jnp.asarray(np.stack([kfs[23].R, kfs[0].R])),
            jnp.asarray(np.stack([kfs[23].t, kfs[0].t])), g))
        assert np.abs(r).max() < 5e-2


@pytest.mark.slow
def test_signature_recall_on_warped_real_keyframes(stereo_pair):
    """r2 verdict weak #7: the 512-bin bit-frequency signature's recall
    under realistic viewpoint/illumination drift, probed on REAL imagery
    where all signatures correlate (not the trivially separable random
    fields above).  Keyframes are distinct crops of the stock image;
    queries are shifted + photometrically perturbed versions.  The true
    keyframe must rank inside the loop_candidates=4 prefilter window for
    >= 80% of queries — prefilter misses are silent lost loops."""
    from akaze_jax import Akaze, AkazeConfig

    left, _ = stereo_pair
    det = Akaze(AkazeConfig(max_pts=1024, noctaves=2))
    h, w = 192, 256
    # 12 distinct scenes tiled out of the image
    origins = [(y, x) for y in (0, 200, 400, 600)
               for x in (0, 400, 800)]
    idx = KeyframeIndex()
    feats = []
    for (oy, ox) in origins:
        crop = left[oy:oy + h, ox:ox + w].astype(np.float32) / 255.0
        f = det.detect_and_compute(crop)
        idx.add(f)
        feats.append(f)

    rng = np.random.default_rng(3)
    hits = 0
    n_q = len(origins)
    for qi, (oy, ox) in enumerate(origins):
        # viewpoint shift (6, 9) px + brightness/contrast drift + noise
        crop = left[oy + 6:oy + 6 + h, ox + 9:ox + 9 + w].astype(
            np.float32) / 255.0
        crop = np.clip(0.85 * crop + 0.05
                       + 0.02 * rng.standard_normal(crop.shape), 0, 1)
        fq = det.detect_and_compute(crop.astype(np.float32))
        sig_q = KeyframeIndex._signature(np.asarray(fq.words),
                                         np.asarray(fq.valid))
        sims = np.asarray(idx._sigs) @ sig_q
        top4 = np.argsort(-sims)[:4]
        hits += int(qi in top4)
    recall = hits / n_q
    assert recall >= 0.8, f"prefilter recall {recall} on warped keyframes"
