"""Per-stage device times of the AKAZE pipeline on one GPU.

Each stage is jitted alone on inputs precomputed by the earlier stages and
timed with the host clock around ``block_until_ready`` after warm-up
(akaze_jax.profiling.time_call).  The scale space is also timed per octave,
as the difference between plans with k and k - 1 octaves.  Runs on the stock
pair where ``data/`` holds it, else on the seeded synthetic pair of the same
shape (io.stock_pair).

    python benchmarks/profile_stages.py [--fixed] [--iters N]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np

# fallback when akaze_jax is not pip-installed: the repo root
sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from akaze_jax import AkazeConfig  # noqa: E402
from akaze_jax.descriptor import (compute_descriptors,  # noqa: E402
                                  compute_orientation)
from akaze_jax.detect import detect_keypoints, flatten_pyramid  # noqa: E402
from akaze_jax.io import stock_pair  # noqa: E402
from akaze_jax.match import match  # noqa: E402
from akaze_jax.pipeline import detect_and_compute_pair  # noqa: E402
from akaze_jax.plan import build_plan  # noqa: E402
from akaze_jax.profiling import enable_compile_cache, time_call  # noqa
from akaze_jax.scale_space import build_scale_space  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--fixed", action="store_true")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    if jax.devices()[0].platform != "gpu":
        sys.exit("profile_stages.py times the GPU; no GPU found")
    enable_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    left, right, source = stock_pair()
    fixed = args.fixed
    conv = ((lambda a: jnp.asarray(a.astype(np.int32))) if fixed
            else (lambda a: jnp.asarray(a.astype(np.float32) / 255.0)))
    img, img_b = conv(left), conv(right)
    h, w = left.shape
    cfg = AkazeConfig(max_pts=10000)
    plan = build_plan(h, w, cfg)
    print(f"device: {jax.devices()[0].device_kind} | {card} | pair: "
          f"{source} {h}x{w} | fixed={fixed} | octaves={len(plan.octaves)}")

    def t(name, fn, *a):
        ms = time_call(fn, *a, iters=args.iters) * 1000
        print(f"{name:<26s} {ms:9.3f} ms   [{card}]", flush=True)
        return ms

    # scale space, whole and per octave (difference of k-octave plans)
    prev = 0.0
    for k in range(1, len(plan.octaves) + 1):
        pk = build_plan(h, w, AkazeConfig(max_pts=10000, noctaves=k))
        ms = time_call(lambda im, pk=pk: build_scale_space(im, pk, fixed),
                       img, iters=args.iters) * 1000
        print(f"scale_space octave {k - 1:<7d} {ms - prev:9.3f} ms   "
              f"(cumulative {ms:.3f})   [{card}]", flush=True)
        prev = ms
    octaves, _ = jax.jit(lambda im: build_scale_space(im, plan, fixed))(img)
    t("detect (extrema..refine)",
      lambda o: detect_keypoints(o, plan, fixed, buckets=True), octaves)
    kps = jax.jit(lambda o: detect_keypoints(o, plan, fixed, True))(octaves)
    flat = jax.jit(flatten_pyramid)(octaves)
    t("orientation", lambda k, f: compute_orientation(k, f, plan, fixed),
      kps, flat)
    angle = jax.jit(lambda k, f: compute_orientation(k, f, plan, fixed))(
        kps, flat)
    t("descriptors",
      lambda k, a, f: compute_descriptors(k, a, f, plan, fixed), kps, angle,
      flat)
    fa, fb = jax.jit(lambda a, b: detect_and_compute_pair(a, b, plan,
                                                          fixed))(img, img_b)
    print(f"live keypoints: {int(fa.count)} / {int(fb.count)}")
    for route in ("off", "auto"):
        t(f"match ({'xla' if route == 'off' else 'kernel'})",
          lambda a, b, route=route: match(a.words, a.valid, b.words, b.valid,
                                          b.x, b.y, cfg.max_dist, route),
          fa, fb)

    # end to end, both matcher routes, in turns
    for route in ("off", "auto", "off", "auto"):
        def pair(a, b, route=route):
            f1, f2 = detect_and_compute_pair(a, b, plan, fixed)
            return match(f1.words, f1.valid, f2.words, f2.valid, f2.x,
                         f2.y, cfg.max_dist, route)

        t(f"FULL pair + match ({'xla' if route == 'off' else 'kernel'})",
          pair, img, img_b)


if __name__ == "__main__":
    main()
