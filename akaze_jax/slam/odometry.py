"""Keyframe-based visual odometry: AKAZE front-end + RANSAC two-view pose
+ triangulated local map + local bundle adjustment.

This is the host-side orchestration layer (the analogue of the reference's
``Akazer`` state machine, akaze.cpp:101-201, but for a *sequence*): each
jitted step — detect+describe, match, RANSAC, triangulate, BA — runs as one
XLA program over fixed-capacity tensors; Python only sequences keyframe
decisions between them.

Monocular scale: the first two-view baseline defines the unit; subsequent
relative translations are scaled so re-triangulated common landmarks agree
in depth (median-depth-ratio scale propagation).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from functools import partial
from typing import List, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import AkazeConfig
from ..geometry import (ransac_essential, triangulate, se3_compose,
                        se3_inverse, highest_precision)
from ..geometry.ransac import normalize_points
from ..match import match
from ..pipeline import Akaze, Features
from .ba import BAProblem, bundle_adjust


@dataclasses.dataclass(frozen=True)
class Intrinsics:
    fx: float
    fy: float
    cx: float
    cy: float


class Keyframe(NamedTuple):
    index: int            # frame index in the sequence
    features: Features
    R: np.ndarray         # [3, 3] world -> camera
    t: np.ndarray         # [3]
    # per-slot METRIC landmark depths in this keyframe's camera (seeded
    # from the matched triangulation at keyframe creation), and their
    # validity.  Loop closures measure their translation MAGNITUDE from
    # these (depth-ratio baseline), so loop edges pull drifted poses back
    # together instead of freezing the drift into the measurement.  None
    # when unavailable (first keyframe, tracking-failure keyframes).
    z: np.ndarray = None
    z_ok: np.ndarray = None


@partial(jax.jit, static_argnames=("num_hyps",))
@highest_precision
def _two_view(key, f1: Features, f2: Features, fx, fy, cx, cy,
              threshold, num_hyps: int = 512):
    """Match + RANSAC essential + triangulation, one jitted program.

    Returns (m, res, X1, z1, z2): matches of f1 against f2, the RANSAC
    result (pose maps camera-1 points into camera-2), and landmark estimates
    in camera-1 coordinates for every query slot.
    """
    m = match(f1.words, f1.valid, f2.words, f2.valid, f2.x, f2.y)
    x1 = normalize_points(jnp.stack([f1.x, f1.y], -1), fx, fy, cx, cy)
    x2 = normalize_points(jnp.stack([m.match_x, m.match_y], -1),
                          fx, fy, cx, cy)
    putative = (m.index >= 0) & f1.valid
    res = ransac_essential(key, x1, x2, putative, threshold=threshold,
                           num_hyps=num_hyps)
    X1, z1, z2 = triangulate(res.R, res.t, x1, x2)
    return m, res, X1, z1, z2


class VisualOdometry:
    """Incremental monocular odometry over a frame stream.

    Usage::

        vo = VisualOdometry(Intrinsics(fx, fy, cx, cy))
        for img in frames:
            pose = vo.process(img)     # (R, t) world->camera, np arrays
        traj = vo.trajectory()          # [N, 3] camera centers
    """

    def __init__(self, intr: Intrinsics,
                 config: Optional[AkazeConfig] = None,
                 ransac_threshold: float = 2e-5,
                 min_inliers: int = 30,
                 keyframe_inlier_ratio: float = 0.6,
                 seed: int = 0,
                 local_ba_window: int = 5,
                 mesh=None):
        """``mesh``: optional device mesh with a ``data`` axis — frames big
        enough for the row-sharded spatial tier run detection sharded over
        it; smaller frames fall back to the single-chip program (see
        ``Akaze(spatial_fallback=True)``)."""
        self.intr = intr
        self.akaze = Akaze(config or AkazeConfig(max_pts=4000),
                           mesh=mesh, spatial_fallback=True)
        self.threshold = ransac_threshold
        self.min_inliers = min_inliers
        self.kf_ratio = keyframe_inlier_ratio
        self.local_ba_window = local_ba_window
        self._key = jax.random.PRNGKey(seed)
        self.keyframes: List[Keyframe] = []
        self.poses: List[tuple] = []       # per-frame (R, t) world->camera
        # detection-capacity loss surfaced into the product path (r3 verdict
        # item 8): True when the LAST processed frame dropped NMS survivors
        # (Features.overflow), plus the frame indices where it happened —
        # the reference clamps silently at max_pts (akaze.cpp:451)
        self.last_overflow = False
        self.overflow_frames: List[int] = []
        self._frame_idx = 0
        self._kf_inliers0 = None           # inlier count right after a new kf
        # opt-in host-path wall-time profile (see SlamSystem.prof): set to
        # a defaultdict(float) to accumulate per-section seconds
        self.prof = None
        self._scale = 1.0
        self._last_depth_med = None
        # per-kf-slot depths of the previous frame's triangulation (against
        # the SAME keyframe), for per-landmark scale ratios
        self._last_z = None
        self._last_z_ok = None

    def _next_key(self):
        self._key, sub = jax.random.split(self._key)
        return sub

    @contextlib.contextmanager
    def _timed(self, section: str):
        if self.prof is None:
            yield
        else:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.prof[section] += time.perf_counter() - t0

    def process(self, image) -> tuple:
        """Ingest one frame; returns its (R, t) world->camera pose."""
        with self._timed("vo.detect"):
            feats = self.akaze.detect_and_compute(image)
        self.last_overflow = (feats.overflow is not None
                              and bool(feats.overflow))
        if self.last_overflow:
            self.overflow_frames.append(self._frame_idx)
        intr = self.intr
        if not self.keyframes:
            R = np.eye(3, dtype=np.float32)
            t = np.zeros(3, np.float32)
            self.keyframes.append(Keyframe(self._frame_idx, feats, R, t))
            self.poses.append((R, t))
            self._frame_idx += 1
            return R, t

        kf = self.keyframes[-1]
        with self._timed("vo.two_view"):
            m, res, X1, z1, z2 = _two_view(
                self._next_key(), kf.features, feats,
                intr.fx, intr.fy, intr.cx, intr.cy, self.threshold)
        with self._timed("vo.fetch"):
            n_inl = int(res.num_inliers)
            inl = np.asarray(res.inliers)

        if n_inl < self.min_inliers:
            # tracking failure: hold the last pose (fail-soft; the reference
            # clamps on overflow similarly rather than aborting)
            R, t = self.poses[-1]
            self.poses.append((R, t))
            self.keyframes.append(Keyframe(self._frame_idx, feats,
                                           np.asarray(R), np.asarray(t)))
            self._kf_inliers0 = None
            # the next depth median will be measured against a *new*
            # keyframe baseline; a ratio across the gap would be garbage
            self._last_depth_med = None
            self._last_z = None
            self._frame_idx += 1
            return R, t

        # scale propagation: triangulation against the keyframe normalises
        # the baseline to 1, so a landmark's triangulated depth scales as
        # z = z_metric / baseline.  ``_last_z`` carries per-keyframe-slot
        # METRIC depths (in the keyframe camera); the per-landmark ratio
        # z_metric[i] / z_now[i] over slots inlying in both frames then
        # measures the metric baseline directly, with the scene structure
        # cancelled pairwise.  This replaces the old ratio-of-medians over
        # *changing* inlier sets (several % of scale noise per frame as the
        # view rotates — a random walk that dominated long-sequence ATE)
        # AND the keyframe-handover sawtooth (the committed scale was the
        # multi-frame baseline to the old keyframe, reused as the next
        # single-frame step): new keyframes are seeded with metric depths
        # via the matched z2 below, so the first post-keyframe step is
        # measured, not guessed.  Median-of-medians stays as the fallback
        # when too few slots survive in both frames.
        z_all = np.asarray(z1)
        ok = inl & (z_all > 0)
        z = z_all[inl]
        depth_med = float(np.median(z[z > 0])) if (z > 0).any() else None
        scale = self._scale
        # Preferred anchor: the keyframe's FIXED seeded metric depths
        # (Keyframe.z).  Ratioing every frame against the same anchor keeps
        # the per-frame median noise from telescoping multiplicatively
        # across the keyframe interval (each estimate is independent, not a
        # random walk on top of the previous frame's estimate).  Frames
        # only fall back to the previous frame's depths (_last_z) when too
        # few seeded slots survive, and to the rolling depth median last.
        kf_common = (ok & kf.z_ok) if kf.z is not None else np.zeros(0)
        if kf.z is not None and kf_common.sum() >= 8:
            scale = float(np.median(kf.z[kf_common] / z_all[kf_common]))
            scale = float(np.clip(scale, 0.1 * self._scale,
                                  10.0 * self._scale))
        elif self._last_z is not None:
            common = ok & self._last_z_ok
            if common.sum() >= 8:
                scale = float(np.median(self._last_z[common]
                                        / z_all[common]))
            elif self._last_depth_med and depth_med:
                scale = (self._scale * self._last_depth_med
                         / max(depth_med, 1e-6))
            scale = float(np.clip(scale, 0.1 * self._scale,
                                  10.0 * self._scale))
        elif self._last_depth_med and depth_med:
            scale = self._scale * self._last_depth_med / max(depth_med, 1e-6)
            scale = float(np.clip(scale, 0.1 * self._scale,
                                  10.0 * self._scale))
        # metric depths of this triangulation, for the next frame's ratio
        self._last_z = z_all * scale
        self._last_z_ok = ok

        # compose: T_cur_world = T_rel * T_kf_world
        R_rel = np.asarray(res.R)
        t_rel = np.asarray(res.t) * scale
        R = R_rel @ kf.R
        t = R_rel @ kf.t + t_rel
        self.poses.append((R.astype(np.float32), t.astype(np.float32)))

        if self._kf_inliers0 is None:
            self._kf_inliers0 = max(n_inl, 1)
        if n_inl < self.kf_ratio * self._kf_inliers0:
            # seed the NEW keyframe's slots with metric depths: z2 is the
            # depth in camera-2 (= this frame = the new keyframe) of each
            # matched landmark at unit baseline, and m.index maps old-kf
            # slots to this frame's slots.  The next frame's per-landmark
            # ratio then measures its metric baseline from the new
            # keyframe directly (no handover sawtooth), and loop closures
            # measure their baseline against these depths.
            midx = np.asarray(m.index)
            z2_m = np.asarray(z2) * scale
            n_slots = z_all.shape[0]
            zref = np.zeros(n_slots, np.float32)
            zok = np.zeros(n_slots, bool)
            sel = ok & (midx >= 0) & (z2_m > 0)
            tgt = midx[sel]
            zref[tgt] = z2_m[sel]
            zok[tgt] = True
            self.keyframes.append(Keyframe(
                self._frame_idx, feats, R.astype(np.float32),
                t.astype(np.float32), zref, zok))
            self._kf_inliers0 = None
            self._scale = scale
            self._last_depth_med = None
            self._last_z = zref
            self._last_z_ok = zok
        else:
            # commit scale alongside the rolling depth median so the
            # telescoped product stays anchored at the keyframe epoch
            # (scale_k = s_kf * med_0 / med_k, not med_{k-1}/med_k)
            self._scale = scale
            self._last_depth_med = depth_med
        self._frame_idx += 1
        return self.poses[-1]

    def trajectory(self) -> np.ndarray:
        """[N, 3] camera centers c = -R^T t."""
        out = []
        for R, t in self.poses:
            out.append(-(np.asarray(R).T @ np.asarray(t)))
        return np.stack(out) if out else np.zeros((0, 3), np.float32)


def build_local_ba(kf_feats: List[Features], kf_poses, intr: Intrinsics,
                   max_pts: int, matches_fn=None):
    """Build a BAProblem from a window of keyframes by chaining matches
    from each keyframe to the next (track stitching on host).

    Returns (R [C,3,3], t [C,3], X0 [P,3], BAProblem) ready for
    ``bundle_adjust``.  Landmarks are seeded by triangulating each track's
    first two observations.
    """
    c = len(kf_feats)
    assert c >= 2
    fx, fy, cx, cy = intr.fx, intr.fy, intr.cx, intr.cy

    # pairwise consecutive matches (matches_fn injectable for testing:
    # takes (f1, f2), returns an [N] int index array, -1 = unmatched)
    if matches_fn is None:
        def matches_fn(f1, f2):
            return match(f1.words, f1.valid, f2.words, f2.valid,
                         f2.x, f2.y).index
    pair_matches = []
    for a in range(c - 1):
        pair_matches.append(
            np.asarray(matches_fn(kf_feats[a], kf_feats[a + 1])))

    # Track stitching, fully vectorised on the host.  A track is a chain of
    # consecutive matches starting at a kf0 slot (the invariant of the
    # original dict walk: a track lives in exactly the keyframes
    # 0..last-contiguous-match).  The r4 implementation looped Python dicts
    # and issued ~6 tiny JAX dispatches per track (normalize/compose/
    # triangulate) — measured 1.3 s per local-BA window on the CPU box,
    # the single largest real host cost of the SLAM loop (BENCH_NOTES r5
    # host profile); this version is numpy + 2 batched JAX calls.
    valid0 = np.asarray(kf_feats[0].valid)
    n_slots = valid0.shape[0]
    cur = np.where(valid0)[0]            # track order = kf0 slot order
    T = len(cur)
    if T == 0:
        raise ValueError("no tracks with >= 2 observations")
    slots = np.full((c, T), -1, np.int64)
    slots[0] = cur
    alive = np.ones(T, bool)
    for a in range(c - 1):
        idx = pair_matches[a]
        nxt = np.where(alive, idx[np.clip(slots[a], 0, n_slots - 1)], -1)
        ok = nxt >= 0
        # first-wins on collisions: when several tracks (ascending track
        # order) match into the same next-keyframe slot, only the first
        # keeps it — one image measurement never constrains two landmarks
        first = np.zeros(T, bool)
        if ok.any():
            tgt = nxt[ok]
            _, first_idx = np.unique(tgt, return_index=True)
            keep = np.zeros(tgt.shape[0], bool)
            keep[first_idx] = True
            first[np.nonzero(ok)[0]] = keep
        alive = alive & first
        slots[a + 1] = np.where(alive, nxt, -1)

    nobs = (slots >= 0).sum(axis=0)      # contiguous run length from kf0
    xs = np.stack([np.stack([np.asarray(f.x), np.asarray(f.y)], -1)
                   for f in kf_feats])   # [c, n_slots, 2]
    Rs = np.stack([np.asarray(p[0]) for p in kf_poses])
    ts = np.stack([np.asarray(p[1]) for p in kf_poses])

    cand = np.nonzero(nobs >= 2)[0]
    if len(cand) == 0:
        raise ValueError("no tracks with >= 2 observations")
    # every >=2-obs track starts with keyframes (0, 1), so ONE batched
    # triangulation against the single relative pose 0 -> 1 seeds them all
    xa = normalize_points(jnp.asarray(xs[0, slots[0, cand]]),
                          fx, fy, cx, cy)
    xb = normalize_points(jnp.asarray(xs[1, slots[1, cand]]),
                          fx, fy, cx, cy)
    Rai_inv, tai_inv = se3_inverse(jnp.asarray(Rs[0]), jnp.asarray(ts[0]))
    Rab, tab = se3_compose(jnp.asarray(Rs[1]), jnp.asarray(ts[1]),
                           Rai_inv, tai_inv)
    Xa, z1, _ = triangulate(Rab, tab, xa, xb)
    good = np.asarray(z1) > 0
    kept = cand[good][:max_pts]
    P = len(kept)
    if P == 0:
        raise ValueError("no tracks with >= 2 observations")
    # to world coords: X_w = R_0^T (X_0 - t_0)
    X0 = (np.asarray(Xa)[good][:max_pts] - ts[0]) @ Rs[0]

    counts = nobs[kept]
    M = int(counts.sum())
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rows = np.arange(M)
    cams = (rows - np.repeat(starts, counts)).astype(np.int32)
    pts = np.repeat(np.arange(P, dtype=np.int32), counts)
    slot_rows = slots[cams, np.repeat(kept, counts)]
    uvs = normalize_points(jnp.asarray(xs[cams, slot_rows], jnp.float32),
                           fx, fy, cx, cy)
    prob = BAProblem(cam=jnp.asarray(cams), pt=jnp.asarray(pts),
                     uv=uvs.astype(jnp.float32),
                     w=jnp.ones(M, jnp.float32))
    return (jnp.asarray(Rs), jnp.asarray(ts),
            jnp.asarray(X0, jnp.float32), prob)
