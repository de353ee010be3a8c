"""Demo / benchmark CLI — the reference's main.cpp as a module entry point.

Replicates the demo lifecycle (main.cpp:17-341): load a grayscale pair,
run detect+describe on both, brute-force match, print counts and stage
timings, and write keypoint/match renderings.

Usage:
    python -m akaze_jax.cli [--left PATH] [--right PATH] [--fixed]
                            [--iters N] [--out-dir DIR] [--max-pts N]
                            [--no-draw]

Without --left/--right the demo runs on the stock pair (``data/`` in the
checkout) or, where that is absent, on a seeded textured pair at the same
960x1280 shape (io.stock_pair).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description="AKAZE demo/benchmark")
    ap.add_argument("--left", help="left image (default: io.stock_pair)")
    ap.add_argument("--right", help="right image (default: io.stock_pair)")
    ap.add_argument("--fixed", action="store_true",
                    help="16.16 fixed-point pipeline (fastakaze)")
    ap.add_argument("--iters", type=int, default=10,
                    help="timing repeats (reference uses 100)")
    ap.add_argument("--out-dir", default=".")
    ap.add_argument("--max-pts", type=int, default=10000)
    ap.add_argument("--no-draw", action="store_true")
    ap.add_argument("--json", action="store_true",
                    help="print one JSON line instead of text")
    ap.add_argument("--spatial", type=int, default=0, metavar="N",
                    help="row-shard each image over an N-device mesh "
                         "(images larger than one card's memory; needs N "
                         "devices)")
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp
    from . import Akaze, AkazeConfig
    from .io import load_gray, stock_pair
    from .match import match as match_fn
    from .pipeline import detect_and_compute_pair
    from .profiling import enable_compile_cache, time_call

    enable_compile_cache()
    if args.left and args.right:
        left, right = load_gray(args.left), load_gray(args.right)
    elif args.left or args.right:
        ap.error("give both --left and --right, or neither")
    else:
        left, right, _ = stock_pair()
    if not args.fixed:
        left_in = left.astype(np.float32) / 255.0
        right_in = right.astype(np.float32) / 255.0
    else:
        left_in, right_in = left, right

    det = Akaze(AkazeConfig(max_pts=args.max_pts), fixed=args.fixed)

    spatial_mesh = None
    if args.spatial > 1:
        from functools import partial
        from .parallel import make_mesh, spatial_detect_and_compute, \
            spatial_supported
        sp_plan = det.plan_for(*left.shape)
        ok, why = spatial_supported(sp_plan, args.spatial, detect=True,
                                    describe=True)
        if not ok:
            ap.error(f"--spatial {args.spatial}: {why}")
        spatial_mesh = make_mesh(args.spatial)
        spatial_fn = jax.jit(partial(
            spatial_detect_and_compute, plan=sp_plan, mesh=spatial_mesh,
            fixed=args.fixed))

    # warm-up / compile (also produces the feature sets for match + draw)
    t0 = time.time()
    if spatial_mesh is not None:
        sp_dt = jnp.int32 if args.fixed else jnp.float32
        fa = spatial_fn(jnp.asarray(left_in).astype(sp_dt))
        fb = spatial_fn(jnp.asarray(right_in).astype(sp_dt))
    else:
        fa, fb = det.detect_and_compute_pair(left_in, right_in)
    m = det.match(fa, fb)
    jax.block_until_ready(m.index)
    compile_s = time.time() - t0

    # device time: host clock around block_until_ready after warm-up
    # (reference protocol: 100-rep averages, main.cpp:199-216)
    h, w = left.shape
    plan = det.plan_for(h, w)
    dt = jnp.int32 if args.fixed else jnp.float32
    la = jnp.asarray(left_in).astype(dt)
    ra = jnp.asarray(right_in).astype(dt)

    def detect_pair(a, b):
        if spatial_mesh is not None:
            from .parallel import spatial_detect_and_compute
            return (spatial_detect_and_compute(a, plan, spatial_mesh,
                                               fixed=det.fixed),
                    spatial_detect_and_compute(b, plan, spatial_mesh,
                                               fixed=det.fixed))
        return detect_and_compute_pair(a, b, plan, det.fixed)

    def match_once(w1, v1, w2, v2, x2, y2):
        return match_fn(w1, v1, w2, v2, x2, y2, det.config.max_dist)

    iters = max(args.iters, 1)
    detect_ms = time_call(detect_pair, la, ra, iters=iters) * 1000
    match_ms = time_call(match_once, fa.words, fa.valid, fb.words, fb.valid,
                         fb.x, fb.y, iters=iters) * 1000

    na, nb = int(fa.count), int(fb.count)
    acc = np.asarray(m.index)[:na] >= 0
    n_match = int(acc.sum())
    overflow = bool(fa.overflow) or bool(fb.overflow)

    if args.json:
        print(json.dumps({
            "left_pts": na, "right_pts": nb, "matches": n_match,
            "detect_pair_ms": round(detect_ms, 3),
            "match_ms": round(match_ms, 3),
            "compile_s": round(compile_s, 1),
            "overflow": overflow,
            "fixed": args.fixed, "backend": jax.default_backend()}))
    else:
        mode = "fastakaze (16.16 int)" if args.fixed else "akaze (float32)"
        print(f"[{mode}] backend={jax.default_backend()}")
        print(f"Number of features: {na} / {nb}")
        print(f"Matched features:   {n_match}")
        print(f"Detect+describe (both images, median of {iters}): "
              f"{detect_ms:.2f} ms")
        print(f"Match: {match_ms:.2f} ms   (compile: {compile_s:.1f} s)")
        if overflow:
            print("warning: keypoint capacity overflow — some NMS "
                  "survivors were dropped (raise max_pts)")

    if not args.no_draw:
        from .viz import draw_keypoints, draw_matches, write_png
        os.makedirs(args.out_dir, exist_ok=True)
        tag = "fastakaze" if args.fixed else "akaze"
        kp_img = draw_keypoints(left, np.asarray(fa.x)[:na],
                                np.asarray(fa.y)[:na],
                                np.asarray(fa.size)[:na])
        write_png(os.path.join(args.out_dir, f"{tag}_keypoints.png"),
                  kp_img)
        mm = draw_matches(left, right,
                          np.asarray(fa.x)[:na], np.asarray(fa.y)[:na],
                          np.asarray(m.match_x)[:na],
                          np.asarray(m.match_y)[:na], acc,
                          horizontal=left.shape[1] <= left.shape[0])
        write_png(os.path.join(args.out_dir, f"{tag}_matches.png"), mm)
        if not args.json:
            print(f"Wrote {tag}_keypoints.png / {tag}_matches.png "
                  f"to {args.out_dir}")


if __name__ == "__main__":
    main()
