"""Frames/s scaling-efficiency benchmark over a device mesh.

On a machine with several GPUs the same code path measures real scaling
over NVLink (the data-parallel pipeline is embarrassingly parallel per
frame; the sharded matcher all-gathers train descriptors; distributed BA
psums per CG iteration).  ``--platform cpu --devices N`` runs it on a
virtual CPU mesh, which validates the sharding program only.

Prints one JSON line per device count plus a summary efficiency figure.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

# fallback when akaze_jax is not pip-installed: add the repo root
sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def bench_dp(n_devices: int, repeats: int = 3, h: int = 192, w: int = 256,
             frames_per_device: int = 1):
    import jax
    import jax.numpy as jnp
    from akaze_jax import AkazeConfig
    from akaze_jax.plan import build_plan
    from akaze_jax.parallel import make_mesh, dp_pipeline_step

    cfg = AkazeConfig(max_pts=512, noctaves=2)
    plan = build_plan(h, w, cfg)
    mesh = make_mesh(n_devices)
    rng = np.random.default_rng(0)
    b = n_devices * frames_per_device
    imgs_a = rng.uniform(0, 1, (b, h, w)).astype(np.float32)
    imgs_b = imgs_a + 0.01 * rng.standard_normal((b, h, w)).astype(
        np.float32)

    # warm-up / compile
    fa, fb, m = dp_pipeline_step(imgs_a, imgs_b, plan, mesh)
    jax.block_until_ready(m)
    t0 = time.time()
    for _ in range(repeats):
        fa, fb, m = dp_pipeline_step(imgs_a, imgs_b, plan, mesh)
    jax.block_until_ready(m)
    dt = (time.time() - t0) / repeats
    return b / dt  # frame pairs per second


def bench_spatial(n_devices: int, repeats: int = 3, h: int = 512,
                  w: int = 256):
    """Row-sharded single-image front-end: one image's rows over the mesh
    (the oversized-image tier; per-device memory is the resource that
    scales, wall-clock gains come second to fitting at all)."""
    import jax
    from functools import partial
    import jax.numpy as jnp
    from akaze_jax import AkazeConfig
    from akaze_jax.plan import build_plan
    from akaze_jax.parallel import (make_mesh, spatial_detect_and_compute,
                                    spatial_supported)

    cfg = AkazeConfig(max_pts=512, noctaves=2)
    plan = build_plan(h, w, cfg)
    ok, why = spatial_supported(plan, n_devices, detect=True, describe=True)
    if not ok:
        return None, why
    mesh = make_mesh(n_devices)
    rng = np.random.default_rng(0)
    img = jnp.asarray(rng.uniform(0, 1, (h, w)).astype(np.float32))

    from akaze_jax.profiling import time_call

    per_iter = time_call(lambda x: spatial_detect_and_compute(x, plan, mesh),
                         img, iters=max(repeats, 1))
    return 1.0 / per_iter, ""  # frames per second


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--platform", default=None,
                    help="force backend, e.g. cpu")
    ap.add_argument("--spatial", action="store_true",
                    help="also run the row-sharded (spatial) front-end "
                         "across device counts")
    ap.add_argument("--devices", type=int, default=8,
                    help="max virtual devices (cpu platform)")
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()

    if args.platform:
        import os
        os.environ["JAX_PLATFORMS"] = args.platform
        flags = os.environ.get("XLA_FLAGS", "")
        if "host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags
                + f" --xla_force_host_platform_device_count={args.devices}"
            ).strip()
        import jax
        jax.config.update("jax_platforms", args.platform)
    import jax

    n_avail = len(jax.devices())
    counts = [n for n in (1, 2, 4, 8, 16, 32) if n <= n_avail]
    results = {}
    for n in counts:
        fps = bench_dp(n, repeats=args.repeats)
        results[n] = fps
        print(json.dumps({"devices": n, "frame_pairs_per_s": round(fps, 2)}))
    if len(counts) > 1:
        base = results[counts[0]]
        eff = {n: results[n] / (base * n) for n in counts[1:]}
        # numbers from a virtual CPU mesh validate only that the sharded
        # program compiles and runs — they are NOT interconnect scaling
        # evidence.  Real efficiency needs several GPUs.
        import jax as _jax
        virtual = (_jax.default_backend() == "cpu")
        print(json.dumps({
            "metric": "frames/s scaling efficiency vs 1 device",
            "evidence": ("program-validity only (virtual CPU mesh)"
                         if virtual else "hardware"),
            "efficiency": {str(n): round(e, 3) for n, e in eff.items()}}))

    if args.spatial:
        for n in counts:
            fps, why = bench_spatial(n, repeats=args.repeats)
            if fps is None:
                print(json.dumps({"spatial_devices": n,
                                  "unsupported": why}))
            else:
                print(json.dumps({"spatial_devices": n,
                                  "frames_per_s": round(fps, 2)}))


if __name__ == "__main__":
    main()
