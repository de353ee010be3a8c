"""Worker process for the multi-process distributed-runtime parity test
(test_multiprocess.py).  Not collected by pytest.

Each worker owns 4 virtual CPU devices (XLA_FLAGS set by the parent),
joins the 2-process cluster through ``initialize_distributed``, builds the
global (host=2, chip=4) mesh, and runs landmark-sharded BA over the global
device set.  Process 0 writes the replicated results for the parent to
compare against its single-process run of the identical program.

Usage: python mp_worker.py <process_id> <coordinator_port> <out_npz>
"""

import os
import sys

import jax

# override in-process in case the environment pins another platform
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_cpu_collectives_implementation", "gloo")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from akaze_jax.profiling import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np  # noqa: E402


def build_problem():
    """Deterministic tiny BA problem, identical in every process."""
    from mp_problem import make_problem
    return make_problem()


def main():
    pid = int(sys.argv[1])
    port = int(sys.argv[2])
    out = sys.argv[3]

    from akaze_jax.parallel import (initialize_distributed,
                                    make_host_chip_mesh,
                                    partition_landmarks, gather_points,
                                    landmark_sharded_bundle_adjust)
    assert initialize_distributed(f"localhost:{port}", num_processes=2,
                                  process_id=pid)
    assert jax.process_count() == 2
    assert len(jax.devices()) == 8, "expected 8 global devices"

    mesh = make_host_chip_mesh(num_hosts=2, chips_per_host=4)

    import jax.numpy as jnp  # noqa: F401
    from jax.sharding import NamedSharding, PartitionSpec as P

    R, t, X0, prob = build_problem()
    part = partition_landmarks(prob, X0.shape[0], 8)
    Xg = np.asarray(gather_points(part, X0))

    def garr(x, spec):
        sh = NamedSharding(mesh, spec)
        return jax.make_array_from_callback(
            x.shape, sh, lambda idx: np.ascontiguousarray(x[idx]))

    axes = ("chip", "host")
    Rg = garr(np.asarray(R), P())
    tg = garr(np.asarray(t), P())
    Xgg = garr(Xg, P(axes))
    prob_g = type(part.prob)(
        cam=garr(np.asarray(part.prob.cam), P(axes)),
        pt=garr(np.asarray(part.prob.pt), P(axes)),
        uv=garr(np.asarray(part.prob.uv), P(axes)),
        w=garr(np.asarray(part.prob.w), P(axes)))
    part_g = part._replace(prob=prob_g)

    R1, t1, X1g, c1 = landmark_sharded_bundle_adjust(
        Rg, tg, Xgg, part_g, mesh, iters=4, cg_iters=12, axis=axes)
    # replicate the sharded landmark block so process 0 can read it whole
    X1rep = jax.jit(lambda x: x,
                    out_shardings=NamedSharding(mesh, P()))(X1g)
    jax.block_until_ready(X1rep)

    if pid == 0:
        np.savez(out, R=np.asarray(R1), t=np.asarray(t1),
                 X=np.asarray(X1rep), cost=float(c1))

    # ---- r3: DP front-end with per-host feeding + the all-gather
    # matcher across the process boundary (r2 verdict item #8) ----
    from akaze_jax import AkazeConfig
    from akaze_jax.plan import build_plan
    from akaze_jax.pipeline import detect_and_compute
    from akaze_jax.parallel import (make_mesh, dp_pipeline_step_multihost,
                                    sharded_match, process_local_batch)
    from mp_problem import make_frames

    h, w = 96, 128
    cfg = AkazeConfig(max_pts=256, noctaves=2)
    plan = build_plan(h, w, cfg)
    dmesh = make_mesh(8)
    imgs_a, imgs_b = make_frames(h, w, 8)
    lb = process_local_batch(8)          # 4 frames fed by THIS process
    lo = pid * lb
    fa, fb, m = dp_pipeline_step_multihost(
        imgs_a[lo:lo + lb], imgs_b[lo:lo + lb], plan, dmesh)
    jax.block_until_ready(m.index)

    def local_rows(arr):
        shards = sorted(arr.addressable_shards,
                        key=lambda s: s.index[0].start or 0)
        return np.concatenate([np.asarray(s.data) for s in shards], 0)

    # cross-process matcher: each process feeds the 256-slot half built
    # from ITS first local frame pair -> a gathered multi-source train
    # set whose validity is prefix-per-shard, not a global prefix
    fl_a = detect_and_compute(jnp.asarray(imgs_a[lo]), plan)
    fl_b = detect_and_compute(jnp.asarray(imgs_b[lo]), plan)
    sh = NamedSharding(dmesh, P("data"))

    def mk(x):
        return jax.make_array_from_process_local_data(sh, np.asarray(x))

    sm = sharded_match(mk(fl_a.words), mk(fl_a.valid), mk(fl_b.words),
                       mk(fl_b.valid), mk(fl_b.x), mk(fl_b.y), dmesh,
                       cfg.max_dist)
    rep = jax.jit(lambda i, d: (i, d),
                  out_shardings=NamedSharding(dmesh, P()))(
        sm.index, sm.distance)
    jax.block_until_ready(rep)

    np.savez(f"{out}.front{pid}.npz",
             x=local_rows(fa.x), count=local_rows(fa.count),
             words=local_rows(fa.words), midx=local_rows(m.index),
             sm_index=np.asarray(rep[0]), sm_dist=np.asarray(rep[1]))

    # ---- r3: row-sharded (spatial) front-end across the process
    # boundary — the ppermute halo exchange between devices 3 and 4
    # crosses processes (gloo); detection must stay exact vs the
    # parent's unsharded program ----
    from functools import partial
    from akaze_jax.parallel import spatial_detect_and_compute
    from mp_problem import make_big_image

    hs, ws = 256, 320
    cfg_sp = AkazeConfig(max_pts=512)
    plan_sp = build_plan(hs, ws, cfg_sp)
    img = make_big_image(hs, ws)
    sh_rows = NamedSharding(dmesh, P("data", None))
    rows_per_proc = hs // 2
    img_g = jax.make_array_from_process_local_data(
        sh_rows, img[pid * rows_per_proc:(pid + 1) * rows_per_proc])
    sp = jax.jit(partial(spatial_detect_and_compute, plan=plan_sp,
                         mesh=dmesh, describe=False))(img_g)
    jax.block_until_ready(sp.x)
    if pid == 0:
        np.savez(f"{out}.spatial.npz",
                 x=np.asarray(sp.x), y=np.asarray(sp.y),
                 layer=np.asarray(sp.layer),
                 response=np.asarray(sp.response),
                 count=int(sp.count))

    # all processes must stay alive until the collectives complete
    jax.distributed.shutdown()
    print(f"worker {pid} done", flush=True)


if __name__ == "__main__":
    main()
