"""Where the SLAM back-end's result on an accelerator parts from the CPU's.

Runs ``long_sequence_eval.run`` in the configuration of chip_smoke.py's
phase f on the default device and replays every two-view solve
(``odometry._two_view``: match, RANSAC, triangulation) on the CPU backend
with the same inputs.  For each solve it prints whether the matches, the
RANSAC minimal sets, the per-hypothesis inlier counts, the chosen
hypothesis and the final inlier set agree, and the angles between the two
rotations and between the two translation directions.  ``--variant`` swaps
one suspect of the run (both sides of the replay):

  stock              the program as it stands
  host-linalg        eigh, SVD and QR by numpy in float64 on the host
  default-precision  the solvers' f32 products at the backend's default
                     precision (TF32 on Hopper) instead of HIGHEST

    python benchmarks/backend_diff.py [--variant stock host-linalg ...]

Prints one line per solve and one JSON line per variant.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "benchmarks"))

SLAM_KW = dict(n_frames=20, laps=1 / 3, local_ba_every=4, n_world_pts=600,
               n_pad=256, chain=True)


def _angle_deg(Ra, Rb):
    """Rotation angle of Ra^T Rb from the chord ||Ra - Rb||_F (arccos of
    the trace would read f32 rounding of a rotation as ~0.02 degrees)."""
    d = np.linalg.norm(np.asarray(Ra, np.float64) - np.asarray(Rb, np.float64))
    return float(np.degrees(2 * np.arcsin(min(d / (2 * np.sqrt(2)), 1.0))))


def _dir_deg(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    d = np.linalg.norm(a / np.linalg.norm(a) - b / np.linalg.norm(b))
    return float(np.degrees(2 * np.arcsin(min(d / 2, 1.0))))


def _host_linalg():
    """Patch jnp.linalg.eigh / svd / qr to numpy float64 host callbacks."""
    import jax
    import jax.numpy as jnp

    def call(fn, shapes, a):
        def cb(x):
            return tuple(np.asarray(r, np.float32)
                         for r in fn(np.asarray(x, np.float64)))
        return jax.pure_callback(cb, shapes, a)

    def eigh(a, *args, **kw):
        f = jnp.float32
        return call(np.linalg.eigh, (
            jax.ShapeDtypeStruct(a.shape[:-1], f),
            jax.ShapeDtypeStruct(a.shape, f)), a)

    def svd(a, *args, **kw):
        f = jnp.float32
        return call(np.linalg.svd, (
            jax.ShapeDtypeStruct(a.shape, f),
            jax.ShapeDtypeStruct(a.shape[:-1], f),
            jax.ShapeDtypeStruct(a.shape, f)), a)

    def qr(a, mode="reduced"):
        assert mode == "r", mode
        return call(lambda x: (np.linalg.qr(x, mode="r"),), (
            jax.ShapeDtypeStruct(a.shape[:-2] + (a.shape[-1],) * 2,
                                 jnp.float32),), a)[0]

    jnp.linalg.eigh, jnp.linalg.svd, jnp.linalg.qr = eigh, svd, qr


def _ransac_internals():
    import jax
    import jax.numpy as jnp
    from akaze_jax.geometry import se3
    from akaze_jax.geometry.epipolar import essential_from_eight, sampson_error
    from akaze_jax.geometry.ransac import _sample_minimal_sets

    @jax.jit
    @se3.highest_precision
    def internals(key, x1, x2, valid, threshold):
        idx = _sample_minimal_sets(key, valid, 512, 8)
        Es = essential_from_eight(x1[idx], x2[idx])
        err = sampson_error(Es, x1[None], x2[None])
        counts = jnp.sum(((err < threshold) & valid[None]).astype(jnp.int32),
                         axis=1)
        return idx, counts, jnp.argmax(counts)
    return internals


def run_variant(variant, cpu, with_cpu_run, verbose=True):
    import jax
    import long_sequence_eval as lse
    from akaze_jax.geometry.ransac import normalize_points
    from akaze_jax.slam import odometry, system

    jax.clear_caches()
    if variant == "host-linalg":
        _host_linalg()
    orig = odometry._two_view
    internals = _ransac_internals()
    rows = []

    def replayed(key, f1, f2, fx, fy, cx, cy, threshold, num_hyps=512):
        out = orig(key, f1, f2, fx, fy, cx, cy, threshold,
                   num_hyps=num_hyps)
        host = jax.device_get((key, f1, f2))
        with jax.default_device(cpu):
            ref = orig(*jax.device_put(host, cpu), fx, fy, cx, cy,
                       threshold, num_hyps=num_hyps)
        (m, res, _, z1, _), (rm, rres, _, rz1, _) = jax.device_get((out, ref))
        # RANSAC internals on both backends from the device's matches
        f1h = host[1]
        x1 = normalize_points(np.stack([f1h.x, f1h.y], -1), fx, fy, cx, cy)
        x2 = normalize_points(np.stack([m.match_x, m.match_y], -1),
                              fx, fy, cx, cy)
        putative = (m.index >= 0) & f1h.valid
        args = (host[0], np.asarray(x1), np.asarray(x2), putative,
                np.float32(threshold))
        gi = jax.device_get(internals(*args))
        with jax.default_device(cpu):
            ci = jax.device_get(internals(*jax.device_put(args, cpu)))
        inl = np.asarray(res.inliers) & np.asarray(rres.inliers)
        row = dict(
            matches_same=bool((m.index == rm.index).all()),
            samples_same=bool((gi[0] == ci[0]).all()),
            hyp_counts_differ=int((gi[1] != ci[1]).sum()),
            best=(int(gi[2]), int(ci[2])),
            inliers=(int(res.num_inliers), int(rres.num_inliers)),
            inlier_sets_same=bool((res.inliers == rres.inliers).all()),
            rot_deg=_angle_deg(res.R, rres.R),
            t_dir_deg=_dir_deg(res.t, rres.t),
            z1_rel=float(np.median(np.abs(z1[inl] - rz1[inl])
                                   / np.maximum(np.abs(rz1[inl]), 1e-12)))
            if inl.any() else None)
        rows.append(row)
        if verbose:
            print(f"    solve {len(rows):2d}: {json.dumps(row)}", flush=True)
        return out

    patch = (_default_precision if variant == "default-precision"
             else contextlib.nullcontext)
    odometry._two_view = system._two_view = replayed
    try:
        with patch():
            rec = lse.run(**SLAM_KW)
    finally:
        odometry._two_view = system._two_view = orig
    out = dict(variant=variant, device=str(jax.devices()[0].device_kind),
               ate_slam=rec["ate_slam"], ate_chain=rec["ate_chain"],
               keyframes=rec["keyframe_index"],
               solves=len(rows),
               solves_with_other_best=sum(r["best"][0] != r["best"][1]
                                          for r in rows),
               solves_with_other_inliers=sum(not r["inlier_sets_same"]
                                             for r in rows),
               max_rot_deg=max(r["rot_deg"] for r in rows),
               max_t_dir_deg=max(r["t_dir_deg"] for r in rows))
    if with_cpu_run:
        with jax.default_device(cpu), patch():
            ref = lse.run(**SLAM_KW)
        out.update(cpu_ate_slam=ref["ate_slam"], cpu_ate_chain=ref["ate_chain"],
                   cpu_keyframes=ref["keyframe_index"])
    if verbose:
        print(json.dumps(out), flush=True)
    return out


@contextlib.contextmanager
def _default_precision():
    """Make ``se3.highest_precision`` a no-op while tracing."""
    import jax
    saved = jax.default_matmul_precision
    jax.default_matmul_precision = lambda _: contextlib.nullcontext()
    try:
        yield
    finally:
        jax.default_matmul_precision = saved


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", nargs="+", default=["stock"],
                    choices=["stock", "host-linalg", "default-precision"])
    ap.add_argument("--cpu-run", action="store_true",
                    help="also run the whole sequence on the CPU backend")
    args = ap.parse_args(argv)
    plats = os.environ.get("JAX_PLATFORMS", "")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"
    import jax
    from akaze_jax.profiling import enable_compile_cache
    enable_compile_cache()
    cpu = jax.devices("cpu")[0]
    print(f"default device: {jax.devices()[0].device_kind}", flush=True)
    # host-linalg patches jnp for the rest of the process: run it last
    order = sorted(args.variant, key=lambda v: v == "host-linalg")
    for v in order:
        print(f"variant {v}", flush=True)
        run_variant(v, cpu, args.cpu_run)


if __name__ == "__main__":
    main()
