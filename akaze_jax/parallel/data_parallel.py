"""Data-parallel frame processing over a device mesh.

The reference processes frames sequentially on one GPU (main.cpp:201-205).
Here a batch of frames is sharded over the ``data`` mesh axis and every
device runs the UNBATCHED single-frame program — the same program, matcher
kernel included, as the single-card path — on its local frames via
``shard_map`` + ``lax.scan``.

``batched_detect_and_compute`` (vmap) remains for intra-device batching of
SMALL frames, where one frame cannot fill the card.
"""

from __future__ import annotations

import functools
from functools import partial

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..pipeline import Features, detect_and_compute, detect_and_compute_pair
from ..plan import PipelinePlan
from ..match import match


def batched_detect_and_compute(images, plan: PipelinePlan,
                               fixed: bool = False) -> Features:
    """vmap of the single-frame pipeline over a leading batch axis
    (intra-device batching)."""
    # refine_buckets off: under vmap a lax.switch runs ALL branches
    return jax.vmap(lambda im: detect_and_compute(
        im, plan, fixed, refine_buckets=False))(images)


@functools.lru_cache(maxsize=None)
def make_dp_step(plan: PipelinePlan, mesh: Mesh, fixed: bool = False,
                 match_pallas: str = "auto", axis: str = "data"):
    """The jitted shard_map program of ``dp_pipeline_step`` (exposed so
    tests can inspect its jaxpr/HLO for the matcher kernel).  Cached per
    (plan, mesh, ...): a fresh jit object per call would recompile the
    step on every call."""
    spec = P(axis)

    # check_vma=False: the local step is collective-free (pure per-device
    # compute), and the varying-manual-axes checker rejects the pipeline's
    # internal scans whose carries start from unsharded constants
    @partial(shard_map, mesh=mesh, in_specs=(spec, spec),
             out_specs=(spec, spec, spec), check_vma=False)
    def local_step(a, b):
        # sequential scan over the device's local frames: each step is the
        # full unbatched pair program, as on a single card
        def frame(carry, pair):
            ia, ib = pair
            fa, fb = detect_and_compute_pair(ia, ib, plan, fixed)
            m = match(fa.words, fa.valid, fb.words, fb.valid, fb.x, fb.y,
                      plan.config.max_dist, use_pallas=match_pallas)
            return carry, (fa, fb, m)

        _, out = jax.lax.scan(frame, None, (a, b))
        return out

    return jax.jit(local_step)


def dp_pipeline_step(images_a, images_b, plan: PipelinePlan, mesh: Mesh,
                     fixed: bool = False, match_pallas: str = "auto"):
    """One data-parallel step: detect+describe+match B frame pairs sharded
    over the mesh's ``data`` axis, each device running the unbatched
    pipeline on its shard.  Returns (features_a, features_b,
    matches) with batch-sharded layouts."""
    sharding = NamedSharding(mesh, P("data"))
    step = make_dp_step(plan, mesh, fixed, match_pallas)
    a = jax.device_put(images_a, sharding)
    b = jax.device_put(images_b, sharding)
    return step(a, b)


def dp_pipeline_step_multihost(local_a, local_b, plan: PipelinePlan,
                               mesh: Mesh, fixed: bool = False,
                               match_pallas: str = "auto"):
    """Multi-host data-parallel step: every process passes only its OWN
    shard of the global batch (per-host data feeding,
    distributed.process_local_batch sizes it) and the global batch-sharded
    arrays are assembled from the process-local pieces.  Single-process
    meshes degenerate to ``dp_pipeline_step``."""
    sharding = NamedSharding(mesh, P("data"))
    a = jax.make_array_from_process_local_data(sharding, local_a)
    b = jax.make_array_from_process_local_data(sharding, local_b)
    step = make_dp_step(plan, mesh, fixed, match_pallas)
    return step(a, b)
