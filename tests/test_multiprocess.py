"""Multi-process distributed-runtime parity: two OS processes, 4 virtual
CPU devices each, joined by ``initialize_distributed`` into one 8-device
(host=2, chip=4) mesh, must reproduce the single-process 8-device result of
landmark-sharded BA (SURVEY.md §5's multi-host north star, exercised
cluster-free).

The SPMD program is identical in both runs; only the runtime differs
(in-process XLA collectives vs gloo across processes), so agreement here
validates the whole multi-host stack: bootstrap, global mesh construction,
global array creation from per-process shards, hierarchical psums over
("chip", "host"), and cross-process replication of results.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import jax


HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.mark.slow
def test_two_process_landmark_ba_matches_single_process(tmp_path):
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")

    # single-process reference on this process's own (2, 4) host/chip mesh
    sys.path.insert(0, HERE)
    from mp_problem import make_problem
    from akaze_jax.parallel import (make_host_chip_mesh, partition_landmarks,
                                    gather_points,
                                    landmark_sharded_bundle_adjust)
    R, t, X0, prob = make_problem()
    part = partition_landmarks(prob, X0.shape[0], 8)
    Xg = gather_points(part, X0)
    mesh = make_host_chip_mesh(num_hosts=2, chips_per_host=4)
    R1, t1, X1, c1 = landmark_sharded_bundle_adjust(
        R, t, Xg, part, mesh, iters=4, cg_iters=12, axis=("chip", "host"))

    # two-process run: each worker owns 4 CPU devices
    out = str(tmp_path / "mp_result.npz")
    port = 21000 + os.getpid() % 2000
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "mp_worker.py"), str(pid),
         str(port), out], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for pid in (0, 1)]
    outputs = []
    for p in procs:
        stdout, _ = p.communicate(timeout=600)
        outputs.append(stdout.decode(errors="replace"))
    for p, o in zip(procs, outputs):
        assert p.returncode == 0, f"worker failed:\n{o[-3000:]}"

    got = np.load(out)
    np.testing.assert_allclose(got["R"], np.asarray(R1), atol=1e-5)
    np.testing.assert_allclose(got["t"], np.asarray(t1), atol=1e-5)
    np.testing.assert_allclose(got["X"], np.asarray(X1), atol=1e-4)
    np.testing.assert_allclose(got["cost"], float(c1), rtol=1e-4,
                               atol=1e-8)

    # ---- front-end parity (r2 verdict item #8): the workers' DP
    # detect+describe shards, fed per-host, must reassemble to the
    # single-process DP result; the cross-process all-gather matcher must
    # agree with the single-process matcher on the same gathered set ----
    from mp_problem import make_frames
    import jax.numpy as jnp
    from akaze_jax import AkazeConfig
    from akaze_jax.plan import build_plan
    from akaze_jax.pipeline import detect_and_compute
    from akaze_jax.match import match
    from akaze_jax.parallel import make_mesh, dp_pipeline_step

    h, w = 96, 128
    cfg = AkazeConfig(max_pts=256, noctaves=2)
    plan = build_plan(h, w, cfg)
    imgs_a, imgs_b = make_frames(h, w, 8)
    fa, fb, m = dp_pipeline_step(imgs_a, imgs_b, plan, make_mesh(8))

    f0 = np.load(f"{out}.front0.npz")
    f1 = np.load(f"{out}.front1.npz")
    np.testing.assert_array_equal(
        np.concatenate([f0["count"], f1["count"]]), np.asarray(fa.count))
    np.testing.assert_allclose(
        np.concatenate([f0["x"], f1["x"]]), np.asarray(fa.x), atol=1e-3)
    agree = (np.concatenate([f0["midx"], f1["midx"]])
             == np.asarray(m.index)).mean()
    assert agree > 0.99  # near-tie matches may flip across fusion orders

    # single-process reference for the gathered matcher: the same
    # two-frame halves each worker fed (frames 0 and 4)
    qs = [detect_and_compute(jnp.asarray(imgs_a[p * 4]), plan)
          for p in (0, 1)]
    ts = [detect_and_compute(jnp.asarray(imgs_b[p * 4]), plan)
          for p in (0, 1)]
    cat = lambda fs, k: jnp.concatenate([getattr(f, k) for f in fs])
    ref_m = match(cat(qs, "words"), cat(qs, "valid"), cat(ts, "words"),
                  cat(ts, "valid"), cat(ts, "x"), cat(ts, "y"),
                  cfg.max_dist)
    np.testing.assert_array_equal(f0["sm_index"], np.asarray(ref_m.index))
    np.testing.assert_allclose(f0["sm_dist"], np.asarray(ref_m.distance))

    # ---- spatial (row-sharded) front-end across the process boundary:
    # the workers ran detection with image rows sharded over all 8
    # devices (the 3|4 halo exchange crossed hosts); the keypoints must
    # equal the unsharded single-process program exactly ----
    from mp_problem import make_big_image
    from akaze_jax.config import AkazeConfig as _AC

    cfg_sp = _AC(max_pts=512)
    plan_sp = build_plan(256, 320, cfg_sp)
    ref_sp = detect_and_compute(jnp.asarray(make_big_image(256, 320)),
                                plan_sp, describe=False)
    got_sp = np.load(f"{out}.spatial.npz")
    n_sp = int(ref_sp.count)
    assert got_sp["count"] == n_sp and n_sp > 100
    # same keypoints on the same layers; coordinates/responses carry
    # ulp-level FMA-contraction noise (measured <= 5e-5 px / 2e-8) — the
    # gloo-process program fuses the float stencils differently from the
    # in-process compile (same caveat as tests/test_spatial.py's float
    # plane parity)
    np.testing.assert_array_equal(got_sp["layer"][:n_sp],
                                  np.asarray(ref_sp.layer)[:n_sp])
    for f in ("x", "y"):
        np.testing.assert_allclose(got_sp[f][:n_sp],
                                   np.asarray(getattr(ref_sp, f))[:n_sp],
                                   atol=1e-3, err_msg=f)
    np.testing.assert_allclose(got_sp["response"][:n_sp],
                               np.asarray(ref_sp.response)[:n_sp],
                               rtol=1e-4, atol=1e-7)
