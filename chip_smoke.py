"""Smoke check of the whole system on one GPU (``--four-cards``: the mesh
paths on four).

    python chip_smoke.py               # phases a-f on one card
    python chip_smoke.py --four-cards  # phase g only, on four cards

Phases (each prints its comparisons and tolerances; any failure exits
non-zero without printing a result):

  a. device: JAX's device kind, the card's name and power limit
     (nvidia-smi), the JAX version;
  b. float front-end at the stock width: a seeded synthetic textured
     960x1280 pair (B = A shifted by (7, 13)), ``Akaze.detect_and_compute_
     pair`` + ``Akaze.match`` on the card, checked against the known shift
     and against the same jitted program on this process's CPU backend;
  c. the fixed (16.16) front-end, the same way;
  d. golden parity: a 192x256 crop, float and fixed, against the
     independent numpy oracle (tests/golden_pipeline.py) at the tolerances
     of tests/test_full_pipeline_golden.py;
  e. matcher: the compiled Triton kernel, the XLA path and the numpy
     golden at 10,000 slots with phase b's live counts, exactly equal;
     both times;
  f. SLAM back-end: benchmarks/long_sequence_eval.run over 20 frames with
     local BA and PGO, on the card and on the CPU backend, and every
     two-view solve replayed on the CPU (benchmarks/backend_diff.py);
  g. (--four-cards) data-parallel step, sharded matcher, sharded PGO/BA,
     the spatial tier and SlamSystem(mesh=...) against one device.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
Exits non-zero when JAX finds no GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))
CARD = "card not read"
SHIFT = (7, 13)
FEATURES = {}      # the card's float features of phase b, for phase e


class PhaseFailed(Exception):
    pass


def check(cond, what):
    """Print one comparison with its verdict; a failed one ends the run."""
    print(f"    [{'ok' if cond else 'FAIL'}] {what}", flush=True)
    if not cond:
        raise PhaseFailed(what)


def timed(label, seconds):
    print(f"    time {label}: {seconds * 1000:.3f} ms  [{CARD}]", flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()


def host_time(fn, reps=5):
    """Median host-clock seconds of ``fn()`` (which ends in
    block_until_ready), after one warm-up call."""
    import statistics
    fn()
    ts = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t)
    return statistics.median(ts)


def _np(f, n):
    import numpy as np
    return {k: np.asarray(v)[:n] for k, v in f._asdict().items()
            if k not in ("count", "overflow")}


def _bit_flips(w1, w2):
    """Per-keypoint count of differing descriptor bits."""
    import numpy as np
    x = np.bitwise_xor(w1, w2).view(np.uint8)
    return np.unpackbits(x, axis=1).sum(axis=1)


# --------------------------------------------------------------------------
# a. device
# --------------------------------------------------------------------------

def phase_device():
    import jax
    global CARD
    d = jax.devices()[0]
    print(f"a. device: {d.device_kind} ({d.platform}), "
          f"{len(jax.devices())} device(s), jax {jax.__version__}")
    lines = card_line()
    CARD = " / ".join(lines)
    for ln in lines:
        print(f"    nvidia-smi: {ln}")
    check(d.platform == "gpu", f"platform {d.platform!r} == 'gpu'")


# --------------------------------------------------------------------------
# b/c. front-end at the stock width
# --------------------------------------------------------------------------

def phase_frontend(fixed, cpu, shape=(960, 1280), max_pts=10000,
                   min_kps=3000):
    """Known-shift drive on the card + the same program on the CPU.
    The card's float features go to FEATURES for phase e."""
    import jax
    import numpy as np
    from akaze_jax import Akaze, AkazeConfig
    from akaze_jax.io import synthetic_pair

    tag = "c. fixed" if fixed else "b. float"
    print(f"{tag} front-end {shape[0]}x{shape[1]}, max_pts={max_pts}, "
          f"shift {SHIFT}")
    A, B = synthetic_pair(shape, SHIFT, seed=0)
    if fixed:
        a, b = A.astype(np.int32), B.astype(np.int32)
    else:
        a, b = A.astype(np.float32) / 255, B.astype(np.float32) / 255
    det = Akaze(AkazeConfig(max_pts=max_pts), fixed=fixed)

    def run():
        fa, fb = det.detect_and_compute_pair(a, b)
        m = det.match(fa, fb)
        jax.block_until_ready((fa, fb, m))
        return fa, fb, m

    t0 = time.perf_counter()
    fa, fb, m = run()
    print(f"    compile + first call: {time.perf_counter() - t0:.1f} s")
    if not fixed:
        FEATURES["float"] = (fa, fb)
    timed("detect_and_compute_pair + match (median of 5)",
          host_time(run))
    n, nb = int(fa.count), int(fb.count)
    print(f"    keypoints {n} / {nb}, overflow {bool(fa.overflow)} / "
          f"{bool(fb.overflow)}")
    check(n >= min_kps and nb >= min_kps,
          f"live keypoints {n}, {nb} >= {min_kps}")
    idx = np.asarray(m.index)[:n]
    acc = idx >= 0
    dx = np.asarray(m.match_x)[:n][acc] - np.asarray(fa.x)[:n][acc]
    dy = np.asarray(m.match_y)[:n][acc] - np.asarray(fa.y)[:n][acc]
    good = (np.abs(dx + SHIFT[1]) < 1.5) & (np.abs(dy + SHIFT[0]) < 1.5)
    print(f"    accepted {int(acc.sum())} of {n}")
    check(np.median(dx) == -SHIFT[1] and np.median(dy) == -SHIFT[0],
          f"median shift (dx, dy) = ({np.median(dx)}, {np.median(dy)}) "
          f"== ({-SHIFT[1]}, {-SHIFT[0]}) exactly")
    check(good.mean() > 0.85, f"inlier fraction {good.mean():.4f} > 0.85")

    # the same jitted programs on this process's CPU backend
    with jax.default_device(cpu):
        ca, cb = det.detect_and_compute_pair(a, b)
        cm = det.match(ca, cb)
        jax.block_until_ready((ca, cb, cm))
    for name, g, c in (("A", fa, ca), ("B", fb, cb)):
        print(f"    {name} vs the CPU run:")
        k = int(g.count)
        check(int(c.count) == k, f"{name}: CPU count {int(c.count)} == {k}")
        gn, cn = _np(g, k), _np(c, k)
        check((gn["layer"] == cn["layer"]).all(),
              f"{name}: layer and slot order identical")
        dxy = max(np.abs(gn["x"] - cn["x"]).max(),
                  np.abs(gn["y"] - cn["y"]).max())
        dr = np.abs(gn["response"] - cn["response"]) / np.maximum(
            np.abs(cn["response"]), 1e-12)
        da = np.abs(gn["angle"] - cn["angle"])
        da = np.minimum(da, 2 * np.pi - da)
        flips = _bit_flips(gn["words"], cn["words"])
        same_words = int((flips == 0).sum())
        print(f"    {name}: max |dx|,|dy| {dxy:.3g} px; max rel response "
              f"diff {dr.max():.3g}; angles within 1e-4: "
              f"{(da < 1e-4).mean():.4f}; identical descriptors "
              f"{same_words}/{k}; differing bits {int(flips.sum())} of "
              f"{486 * k} (mean {flips.mean():.4f}/kp, max {flips.max()})")
        if fixed:
            check(dxy == 0 and dr.max() == 0,
                  f"{name}: fixed keypoints (x, y, response) bit-identical")
        else:
            check(dxy <= 1e-3, f"{name}: |dx|, |dy| {dxy:.3g} <= 1e-3 px")
            check(dr.max() <= 1e-4, f"{name}: rel response diff "
                  f"{dr.max():.3g} <= 1e-4")
        # angles and bits: float rounding (FMA contraction, summation
        # order, cos/sin/atan2 ulps) differs between XLA's CPU and GPU
        # code and flips rare near-tie histogram maxima, sample positions
        # at a .5 boundary and near-tie cell comparisons
        check((da < 1e-4).mean() > 0.97,
              f"{name}: angles within 1e-4 rad for > 97% of keypoints")
        check(np.median(flips) == 0 and flips.mean() < 2.0,
              f"{name}: descriptor bits vs CPU: median 0 and mean "
              f"{flips.mean():.4f} < 2 flips/kp")
    agree = (np.asarray(cm.index)[:n] == idx).mean()
    print(f"    match index agreement with the CPU run: {agree:.4f}")


# --------------------------------------------------------------------------
# d. golden parity
# --------------------------------------------------------------------------

def phase_golden(crop=(slice(300, 492), slice(400, 656)),
                 shape=(960, 1280)):
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from akaze_jax.io import synthetic_pair
    from test_full_pipeline_golden import (assert_parity, run_golden,
                                           run_pipeline)

    img = synthetic_pair(shape, SHIFT, seed=0)[0][crop]
    print(f"d. golden parity on a {img.shape[0]}x{img.shape[1]} crop "
          "(tolerances of tests/test_full_pipeline_golden.py: exact count, "
          "layer and order; x/y 1e-3 px; response rtol 1e-4; angles 1e-3 "
          "for > 97%; bits median 0, mean < 2/kp)")
    for fixed in (False, True):
        got = run_pipeline(img, fixed)
        want = run_golden(img, fixed)
        try:
            assert_parity(got, want, fixed)
            ok, why = True, ""
        except AssertionError as e:
            ok, why = False, str(e).splitlines()[0] if str(e) else "assert"
        check(ok and len(want["x"]) > 30,
              f"{'fixed' if fixed else 'float'}: {len(got['x'])} keypoints "
              f"match the oracle's {len(want['x'])} {why}")


# --------------------------------------------------------------------------
# e. matcher
# --------------------------------------------------------------------------

def golden_match_chunked(w1, v1, w2, v2, max_dist, chunk=128):
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import numpy as np
    import golden
    idx = np.full(len(w1), -1, np.int32)
    dist = np.full(len(w1), -1.0, np.float32)
    n1 = int(v1.sum())
    n2 = int(v2.sum())
    assert v1[:n1].all() and v2[:n2].all(), "sets are prefix-compacted"
    for q in range(0, n1, chunk):
        e = min(q + chunk, n1)
        idx[q:e], dist[q:e] = golden.match(w1[q:e], v1[q:e], w2[:n2],
                                           v2[:n2], max_dist)
    return idx, dist


def phase_matcher(max_dist=96, route="on"):
    import jax
    import numpy as np
    from akaze_jax.match import match
    from akaze_jax.profiling import time_call

    check("float" in FEATURES, "phase b produced the card's features")
    fa, fb = FEATURES["float"]
    n1, n2 = int(fa.count), int(fb.count)
    print(f"e. matcher at {fa.x.shape[0]} slots, live {n1} x {n2}")
    args = (fa.words, fa.valid, fb.words, fb.valid, fb.x, fb.y)
    ker = jax.jit(lambda *a: match(*a, max_dist, route))(*args)
    xla = jax.jit(lambda *a: match(*a, max_dist, "off"))(*args)
    g_idx, g_dist = golden_match_chunked(
        np.asarray(fa.words), np.asarray(fa.valid), np.asarray(fb.words),
        np.asarray(fb.valid), max_dist)
    for name, m in (("kernel", ker), ("xla", xla)):
        check((np.asarray(m.index) == g_idx).all()
              and (np.asarray(m.distance) == g_dist).all(),
              f"{name}: index and distance equal the numpy golden "
              f"exactly ({int((g_idx >= 0).sum())} accepted)")
    t_ker = time_call(lambda *a: match(*a, max_dist, route), *args,
                      iters=20)
    t_xla = time_call(lambda *a: match(*a, max_dist, "off"), *args,
                      iters=20)
    timed("match, Triton kernel (median of 20)", t_ker)
    timed("match, XLA path (median of 20)", t_xla)


# --------------------------------------------------------------------------
# f. SLAM back-end
# --------------------------------------------------------------------------

SLAM_KW = dict(n_frames=20, laps=1 / 3, local_ba_every=4, n_world_pts=600,
               n_pad=256, chain=False)


def phase_slam(cpu, kw=None):
    import jax
    sys.path.insert(0, os.path.join(REPO, "benchmarks"))
    from backend_diff import run_variant
    from long_sequence_eval import run

    kw = dict(SLAM_KW, **(kw or {}))
    print(f"f. SLAM back-end, long_sequence_eval.run({kw})")
    t0 = time.perf_counter()
    gpu = run(**kw)
    print(f"    card run: {time.perf_counter() - t0:.1f} s")
    with jax.default_device(cpu):
        ref = run(**kw)
    for name, r in (("card", gpu), ("cpu", ref)):
        print(f"    {name}: keyframes {r['keyframe_index']}, ate_slam "
              f"{r['ate_slam']}, sections "
              f"{r['sections']}")
    timed("per frame, first half (mean)",
          gpu["frame_ms_first_half"] / 1000)
    timed("per frame, second half (mean)",
          gpu["frame_ms_second_half"] / 1000)
    check("local_ba" in gpu["sections"] and "pgo" in gpu["sections"],
          "local BA and PGO ran")
    check(gpu["keyframe_index"] == ref["keyframe_index"],
          "keyframe decisions identical to the CPU run")
    # bounds from card readings on this sequence (NVIDIA H100): the
    # 8-point solve from an SVD gives ATE 0.0100 on card and CPU (ATE is
    # reported to 1e-4 m); the earlier eigh(A^T A) solve gave 0.0213 on the
    # card (0.0230 with TF32 products) against 0.0095 on the CPU
    check(abs(gpu["ate_slam"] - ref["ate_slam"]) <= 1e-3,
          f"ATE {gpu['ate_slam']} vs CPU {ref['ate_slam']} within 1e-3 m "
          f"on the {ref['trajectory_length']} m keyframe trajectory")
    # every two-view solve replayed on the CPU with the card's inputs: the
    # same inlier sets, poses within 0.005 deg (rotation) and 0.03 deg
    # (translation direction); card readings 0.0010 / 0.0062 deg, the
    # eigh solve 0.040 / 0.443 deg (TF32: 0.040 / 0.429)
    rep = run_variant("stock", cpu, False, verbose=False)
    print(f"    two-view replay: {rep['solves']} solves, "
          f"{rep['solves_with_other_best']} pick another RANSAC "
          f"hypothesis, {rep['solves_with_other_inliers']} another inlier "
          f"set; max rotation diff {rep['max_rot_deg']:.3g} deg, max "
          f"translation direction diff {rep['max_t_dir_deg']:.3g} deg")
    check(rep["solves_with_other_inliers"] == 0
          and rep["max_rot_deg"] <= 0.005 and rep["max_t_dir_deg"] <= 0.03,
          "two-view solves: inlier sets identical, rotation within 0.005 "
          "deg and translation direction within 0.03 deg of the CPU")


# --------------------------------------------------------------------------
# g. four cards
# --------------------------------------------------------------------------

def _devices_of(tree):
    import jax
    out = set()
    for leaf in jax.tree.leaves(tree):
        if hasattr(leaf, "devices"):
            out |= {d.id for d in leaf.devices()}
    return sorted(out)


def phase_four_cards(shape=(960, 1280), max_pts=10000, n_pairs=8,
                     ba_cams=60, ba_pts=1000, n_dev=4):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from akaze_jax import AkazeConfig
    from akaze_jax.io import synthetic_pair
    from akaze_jax.match import match
    from akaze_jax.parallel import (dp_pipeline_step, make_mesh,
                                    sharded_match,
                                    spatial_detect_and_compute)
    from akaze_jax.pipeline import (_jit_detect_and_compute,
                                    _jit_detect_and_compute_pair)
    from akaze_jax.plan import build_plan

    check(len(jax.devices()) >= n_dev, f"{len(jax.devices())} devices "
          f">= {n_dev}")
    t_start = time.perf_counter()

    def leg(name):
        print(f"  [{time.perf_counter() - t_start:.0f} s] {name}", flush=True)

    mesh = make_mesh(n_dev)
    print(f"g. {n_dev} cards: mesh {dict(mesh.shape)}, devices "
          f"{[d.id for d in mesh.devices.ravel()]}")
    cfg = AkazeConfig(max_pts=max_pts)
    plan = build_plan(*shape, cfg)
    pairs = [synthetic_pair(shape, (1 + i, 2 + 3 * i), seed=10 + i)
             for i in range(n_pairs)]
    ia = np.stack([p[0] for p in pairs]).astype(np.float32) / 255
    ib = np.stack([p[1] for p in pairs]).astype(np.float32) / 255

    # data-parallel step vs the single-card program per pair
    t0 = time.perf_counter()
    fa, fb, m = dp_pipeline_step(ia, ib, plan, mesh)
    jax.block_until_ready(m)
    print(f"    dp step compile + run: {time.perf_counter() - t0:.1f} s; "
          f"output devices {_devices_of((fa, fb, m))}")
    timed(f"dp_pipeline_step, {n_pairs} pairs (median of 5)", host_time(
        lambda: jax.block_until_ready(
            dp_pipeline_step(ia, ib, plan, mesh))))
    dev0 = jax.devices()[0]
    for i in range(n_pairs):
        ra, rb = _jit_detect_and_compute_pair(
            jax.device_put(ia[i], dev0), jax.device_put(ib[i], dev0),
            plan=plan, fixed=False)
        rm = match(ra.words, ra.valid, rb.words, rb.valid, rb.x, rb.y,
                   cfg.max_dist)
        n = int(ra.count)
        ga = _np(jax.tree.map(lambda x: x[i], fa)._replace(
            count=fa.count[i], overflow=fa.overflow[i]), n)
        flips = _bit_flips(ga["words"], np.asarray(ra.words)[:n])
        agree = (np.asarray(m.index[i])[:n] == np.asarray(rm.index)[:n])
        check(int(fa.count[i]) == n
              and np.abs(ga["x"] - np.asarray(ra.x)[:n]).max() <= 1e-3
              and flips.mean() < 2.0 and agree.mean() > 0.99,
              f"dp pair {i}: count {n}, |dx| <= 1e-3, bits "
              f"{flips.mean():.4f}/kp < 2, match agreement "
              f"{agree.mean():.4f} > 0.99")

    leg("sharded matcher")
    # sharded matcher vs match on the last pair (host copies: the
    # single-card features are committed to card 0)
    with mesh:
        sm = sharded_match(*jax.device_get((ra.words, ra.valid, rb.words,
                                            rb.valid, rb.x, rb.y)),
                           mesh, cfg.max_dist)
    jax.block_until_ready(sm)
    print(f"    sharded_match output devices {_devices_of(sm)}")
    check((np.asarray(sm.index) == np.asarray(rm.index)).all()
          and (np.asarray(sm.distance) == np.asarray(rm.distance)).all(),
          "sharded_match index and distance == match")

    leg("sharded solvers")
    _four_card_solvers(mesh, n_dev, ba_cams, ba_pts)
    leg("spatial tier")

    # spatial tier at the stock width: fixed bit-exact, float close
    A = pairs[0][0]
    for fixed in (True, False):
        img = A.astype(np.int32) if fixed else A.astype(np.float32) / 255
        sp = jax.jit(lambda x: spatial_detect_and_compute(
            x, plan, mesh, fixed=fixed))(jnp.asarray(img))
        ref = _jit_detect_and_compute(jax.device_put(img, dev0), plan=plan,
                                      fixed=fixed, describe=True)
        n = int(ref.count)
        print(f"    spatial ({'fixed' if fixed else 'float'}) output "
              f"devices {_devices_of(sp)}, keypoints {int(sp.count)}")
        spn, rfn = _np(sp, n), _np(ref, n)
        flips = _bit_flips(spn["words"], rfn["words"])
        if fixed:
            check(int(sp.count) == n and all(
                (spn[k] == rfn[k]).all() for k in
                ("x", "y", "layer", "response", "angle", "words")),
                  f"spatial fixed: {n} keypoints and descriptors "
                  "bit-exact vs one card")
        else:
            check(int(sp.count) == n
                  and np.abs(spn["x"] - rfn["x"]).max() <= 1e-3
                  and flips.mean() < 2.0,
                  f"spatial float: {n} keypoints, |dx| <= 1e-3, bits "
                  f"{flips.mean():.4f}/kp < 2 vs one card")

    leg("SlamSystem(mesh)")
    _four_card_slam(mesh)
    leg("done")


def _four_card_slam(mesh):
    """SlamSystem(mesh=...) against one device on phase f's sequence (five
    keyframes: local BA and PGO run inside the loop).  Both runs make the
    same two-view solves on one card; only the sharded PGO and local BA
    sum in another order, so the keyframes must match and the ATE agree to
    a millimetre."""
    sys.path.insert(0, os.path.join(REPO, "benchmarks"))
    from long_sequence_eval import run
    t0 = time.perf_counter()
    rec = run(mesh=mesh, **SLAM_KW)
    t1 = time.perf_counter()
    ref = run(mesh=None, **SLAM_KW)
    print(f"    SLAM runs, compile included: mesh {t1 - t0:.1f} s, one "
          f"device {time.perf_counter() - t1:.1f} s")
    print(f"    SLAM mesh: keyframes {rec['keyframe_index']}, ate "
          f"{rec['ate_slam']}, sections {rec['sections']}; one device: "
          f"keyframes {ref['keyframe_index']}, ate {ref['ate_slam']}")
    check("local_ba" in rec["sections"] and "pgo" in rec["sections"],
          "local BA and PGO ran under the mesh")
    check(rec["keyframe_index"] == ref["keyframe_index"]
          and abs(rec["ate_slam"] - ref["ate_slam"]) <= 1e-3,
          f"SlamSystem(mesh) keyframes identical, ATE {rec['ate_slam']} vs "
          f"{ref['ate_slam']} within 1e-3")


def _four_card_solvers(mesh, n_dev, n_cams, n_pts):
    """Edge-sharded PGO, observation- and landmark-sharded BA against the
    single-device solvers on a problem of realistic size."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from test_slam import make_ba_problem, make_trajectory, relative
    from akaze_jax.geometry import se3_compose, se3_exp
    from akaze_jax.slam.ba import ba_cost
    from akaze_jax.parallel import (gather_points,
                                    landmark_sharded_bundle_adjust,
                                    make_host_chip_mesh, pad_edges,
                                    pad_observations, partition_landmarks,
                                    scatter_points, sharded_bundle_adjust,
                                    sharded_optimize_pose_graph)
    from akaze_jax.slam import PoseGraph, bundle_adjust, optimize_pose_graph

    # 60 cameras along a path over a cloud spread along it (~25k
    # observations), 1e-3 (normalized; ~1 px) observation noise, cameras
    # 1.. and points perturbed: the optimum's cost is far from zero, so the
    # relative cost bound binds
    rng = np.random.default_rng(5)
    R, t, X, prob = make_ba_problem(rng, n_cams=n_cams, n_pts=n_pts,
                                    noise=1e-3, span=True)
    n_obs = int(np.asarray(prob.w).sum())
    print(f"    BA problem: {n_cams} cameras, {n_pts} points, {n_obs} "
          "observations")
    check(n_cams >= 50 and n_obs >= 20000,
          "BA problem of >= 50 cameras and >= 20k observations")
    dxi = np.asarray(jax.random.normal(jax.random.PRNGKey(2), (n_cams, 6)))
    dxi = jnp.asarray(dxi * 0.003 * (np.arange(n_cams) > 0)[:, None])
    R, t = jax.vmap(se3_compose)(R, t, *se3_exp(dxi))
    X0 = X + jax.random.normal(jax.random.PRNGKey(3), X.shape) * 0.04
    c0 = float(ba_cost(R, t, X0, prob))
    R1, t1, X1, c1 = bundle_adjust(R, t, X0, prob, n_cams=n_cams,
                                   n_pts=n_pts, iters=6, cg_iters=25)
    print(f"    single-device BA: cost {c0:.6g} -> {float(c1):.6g}")
    check(float(c1) < 0.5 * c0, "single-device BA lowers the cost")

    def same_ba(name, c, Xs):
        dX = np.abs(np.asarray(X1) - Xs).max()
        check(abs(float(c1) - float(c)) <= 1e-3 * float(c1)
              and np.allclose(np.asarray(X1), Xs, rtol=1e-2, atol=1e-3),
              f"{name} BA cost {float(c):.7g} vs {float(c1):.7g} (rtol "
              f"1e-3), points max |dX| {dX:.3g} (rtol 1e-2, atol 1e-3)")

    probp = pad_observations(prob, n_dev)
    R2, t2, X2, c2 = sharded_bundle_adjust(R, t, X0, probp, mesh, iters=6,
                                           cg_iters=25)
    print(f"    obs-sharded BA output devices {_devices_of(X2)}")
    same_ba("observation-sharded", c2, np.asarray(X2))
    mesh_hc = make_host_chip_mesh(num_hosts=1, chips_per_host=n_dev)
    part = partition_landmarks(prob, n_pts, n_dev)
    R3, t3, X3g, c3 = landmark_sharded_bundle_adjust(
        R, t, gather_points(part, X0), part, mesh_hc, iters=6, cg_iters=25,
        axis=("chip", "host"))
    print(f"    landmark-sharded BA on the (host, chip) = "
          f"{tuple(mesh_hc.devices.shape)} mesh, output devices "
          f"{_devices_of(X3g)}")
    same_ba("landmark-sharded", c3, scatter_points(part, X3g))

    # PGO over the same number of poses: odometry edges plus a loop edge
    # every 5 poses, each measurement perturbed (0.01 in se(3)) so that the
    # optimum's cost is not zero
    n = n_cams
    R_true, t_true = make_trajectory(rng, n)
    ei = list(range(n - 1)) + list(range(0, n - 5, 5))
    ej = list(range(1, n)) + [i + 5 for i in range(0, n - 5, 5)]
    rel = [relative(R_true[i], t_true[i], R_true[j], t_true[j])
           for i, j in zip(ei, ej)]
    mR, mt = se3_exp(jnp.asarray(
        rng.standard_normal((len(ei), 6)).astype(np.float32) * 0.01))
    R_ij, t_ij = jax.vmap(se3_compose)(
        jnp.stack([r[0] for r in rel]), jnp.stack([r[1] for r in rel]),
        mR, mt)
    graph = PoseGraph(i=jnp.asarray(ei, jnp.int32),
                      j=jnp.asarray(ej, jnp.int32), R_ij=R_ij, t_ij=t_ij,
                      weight=jnp.ones(len(ei), jnp.float32))
    noise = rng.standard_normal((n, 6)).astype(np.float32) * 0.03
    noise[0] = 0
    dR, dt = se3_exp(jnp.asarray(noise))
    P0 = jax.vmap(se3_compose)(jnp.asarray(R_true), jnp.asarray(t_true),
                               dR, dt)
    gp = pad_edges(graph, n_dev)
    Rp1, tp1, cp1 = optimize_pose_graph(*P0, gp, iters=6)
    Rp2, tp2, cp2 = sharded_optimize_pose_graph(*P0, gp, mesh, iters=6)
    print(f"    edge-sharded PGO ({len(ei)} edges) output devices "
          f"{_devices_of(Rp2)}")
    dP = max(np.abs(np.asarray(Rp1) - np.asarray(Rp2)).max(),
             np.abs(np.asarray(tp1) - np.asarray(tp2)).max())
    check(dP <= 1e-3 and abs(float(cp1) - float(cp2)) <= 1e-3 * float(cp1),
          f"edge-sharded PGO cost {float(cp2):.7g} vs {float(cp1):.7g} "
          f"(rtol 1e-3), poses max diff {dP:.3g} <= 1e-3")


# --------------------------------------------------------------------------

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only phase g, on four cards")
    args = ap.parse_args(argv)

    # keep the CPU backend beside the GPU for the comparisons
    plats = os.environ.get("JAX_PLATFORMS", "")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"
    sys.path.insert(0, REPO)
    import jax
    from akaze_jax.profiling import enable_compile_cache

    if jax.devices()[0].platform != "gpu":
        print(f"no GPU: JAX found {jax.devices()[0].platform!r}",
              file=sys.stderr)
        return 1
    enable_compile_cache()
    failures = []

    def attempt(name, fn, *a):
        """Run one phase; a failure is recorded and the next phase runs,
        so one call reports on every phase."""
        try:
            fn(*a)
        except Exception as e:  # noqa: BLE001 - every failure fails the run
            if not isinstance(e, PhaseFailed):
                traceback.print_exc()
            failures.append(f"{name}: {type(e).__name__}: {e}")

    attempt("a", phase_device)
    if not failures:
        if args.four_cards:
            attempt("g", phase_four_cards)
        else:
            cpu = jax.devices("cpu")[0]
            attempt("b", phase_frontend, False, cpu)
            attempt("c", phase_frontend, True, cpu)
            attempt("d", phase_golden)
            attempt("e", phase_matcher)
            attempt("f", phase_slam, cpu)
    if failures:
        for f in failures:
            print(f"FAILED {f}", file=sys.stderr)
        return 1
    d = jax.devices()
    print(f"card: {CARD}")
    print(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind,
        "count": len(d)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
