"""Headline benchmark: the reference's stock matching test on one GPU.

Protocol (BASELINE.md): detect + describe BOTH images of the stock pair and
brute-force Hamming match, against the reference's 19.56 ms on a GTX 1080
(README.md:15).  The pair is the stock pair where ``data/`` holds it and a
seeded textured pair of the same shape otherwise (io.stock_pair).  The time
is the median of the host clock around ``block_until_ready`` after warm-up.

Refuses to run without a GPU.  Names the card on an earlier line, then
prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.
"""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np

BASELINE_MS = 19.56


def main():
    import jax
    import jax.numpy as jnp
    if jax.devices()[0].platform != "gpu":
        sys.exit(f"bench.py needs a GPU; JAX found "
                 f"{jax.devices()[0].platform!r}")
    from akaze_jax import AkazeConfig
    from akaze_jax.io import stock_pair
    from akaze_jax.match import match
    from akaze_jax.pipeline import detect_and_compute_pair
    from akaze_jax.plan import build_plan
    from akaze_jax.profiling import enable_compile_cache, time_call

    enable_compile_cache()
    left, right, source = stock_pair()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"device: {jax.devices()[0].device_kind} | {card.strip()} | "
          f"pair: {source}")
    l_img = jnp.asarray(left.astype(np.float32) / 255.0)
    r_img = jnp.asarray(right.astype(np.float32) / 255.0)
    cfg = AkazeConfig(max_pts=10000)
    plan = build_plan(*left.shape, cfg)

    def run(a, b):
        f1, f2 = detect_and_compute_pair(a, b, plan)
        return match(f1.words, f1.valid, f2.words, f2.valid, f2.x, f2.y,
                     cfg.max_dist)

    per_iter_ms = time_call(run, l_img, r_img, warmup=3, iters=50) * 1000
    print(json.dumps({
        "metric": "detect+describe+match, stock pair (960x1280), per iteration",
        "value": round(per_iter_ms, 3),
        "unit": "ms",
        "vs_baseline": round(BASELINE_MS / per_iter_ms, 3),
    }))


if __name__ == "__main__":
    main()
