"""Per-flavour headline timings: one JSON line per pipeline flavour.

Measures the full detect+describe+match pair program (the bench.py
protocol: host clock around block_until_ready after warm-up, on the stock
960x1280 pair or its synthetic stand-in, io.stock_pair) for

  * float PM_G2 (the headline default)
  * float PM_G1 / WEICKERT / CHARBONNIER
  * fixed (fastakaze, 16.16 integers)
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--flavours", default="pm_g2,pm_g1,weickert,"
                    "charbonnier,fixed")
    args = ap.parse_args()

    from akaze_jax.profiling import enable_compile_cache, time_call
    enable_compile_cache()
    import jax.numpy as jnp
    from akaze_jax import AkazeConfig, Diffusivity
    from akaze_jax.io import stock_pair
    from akaze_jax.match import match
    from akaze_jax.pipeline import detect_and_compute_pair
    from akaze_jax.plan import build_plan

    left, right, _ = stock_pair()
    h, w = left.shape

    flavours = {
        "pm_g2": dict(),
        "pm_g1": dict(diffusivity=Diffusivity.PM_G1),
        "weickert": dict(diffusivity=Diffusivity.WEICKERT),
        "charbonnier": dict(diffusivity=Diffusivity.CHARBONNIER),
        "fixed": dict(fixed=True),
    }

    for name in args.flavours.split(","):
        kw = dict(flavours[name.strip()])
        fixed = kw.pop("fixed", False)
        cfg = AkazeConfig(max_pts=10000, **kw)
        plan = build_plan(h, w, cfg)
        if fixed:
            a = jnp.asarray(left.astype(np.int32))
            b = jnp.asarray(right.astype(np.int32))
        else:
            a = jnp.asarray(left.astype(np.float32) / 255.0)
            b = jnp.asarray(right.astype(np.float32) / 255.0)

        def run_pair(ia, ib):
            f1, f2 = detect_and_compute_pair(ia, ib, plan, fixed)
            return match(f1.words, f1.valid, f2.words, f2.valid, f2.x,
                         f2.y, cfg.max_dist)

        ms = time_call(run_pair, a, b, iters=max(args.iters, 1)) * 1000
        print(json.dumps({"flavour": name.strip(),
                          "pair_ms": round(ms, 3)}), flush=True)


if __name__ == "__main__":
    main()
