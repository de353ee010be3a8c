"""End-to-end AKAZE pipeline: the ``Akazer`` of the reference.

Replaces the host orchestration of akaze.cpp:101-201 (detectAndCompute /
fastDetectAndCompute): the whole detect+describe path compiles into a single
XLA program per static (height, width, fixed) signature, with no
host<->device round trips (the reference synchronises after every kernel and
copies the contrast histogram and point counter back to the host mid-pipeline,
akazed.cu:2443,2465 / akaze.cpp:450).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .config import AkazeConfig
from .descriptor import compute_descriptors, compute_orientation
from .detect import detect_keypoints, flatten_pyramid
from .match import Matches, match
from .plan import PipelinePlan, build_plan
from .scale_space import build_scale_space


class Features(NamedTuple):
    """Detection + description results in fixed-capacity SoA tensors."""
    x: jax.Array         # [max_pts] float32 full-resolution coords
    y: jax.Array
    size: jax.Array      # [max_pts] float32
    layer: jax.Array     # [max_pts] int32 octave * max_scale + scale
    response: jax.Array  # [max_pts] float32
    angle: jax.Array     # [max_pts] float32 in [0, 2*pi)
    words: jax.Array     # [max_pts, 16] uint32 MLDB bits
    valid: jax.Array     # [max_pts] bool
    count: jax.Array     # scalar int32
    # scalar bool: True when NMS survivors were dropped by a capacity cap
    # (per-tile budget or max_pts) — unlike the reference's silent clamp
    # (akazed.cu:1534), the loss is signalled all the way to the user
    overflow: jax.Array = None


def detect_and_compute(image, plan: PipelinePlan, fixed: bool = False,
                       describe: bool = True,
                       refine_buckets: bool = True) -> Features:
    """Pure function: image -> Features.  Jit with ``plan``/``fixed`` static.

    ``refine_buckets``: count-bucketed refinement gathers — bit-exact and
    faster, but must be disabled under vmap (every lax.switch branch would
    execute; see data_parallel.py)."""
    octaves, _ = build_scale_space(image, plan, fixed)
    kps = detect_keypoints(octaves, plan, fixed, buckets=refine_buckets)
    if describe:
        flat = flatten_pyramid(octaves)
        angle = compute_orientation(kps, flat, plan, fixed)
        words = compute_descriptors(kps, angle, flat, plan, fixed).words
    else:
        angle = jnp.zeros_like(kps.x)
        words = jnp.zeros((kps.x.shape[0], 16), jnp.uint32)
    return Features(x=kps.x, y=kps.y, size=kps.size, layer=kps.layer,
                    response=kps.response, angle=angle, words=words,
                    valid=kps.valid, count=kps.count,
                    overflow=kps.overflow)


def detect_and_compute_pair(image_a, image_b, plan: PipelinePlan,
                            fixed: bool = False):
    """Both images of a matching pair in ONE program (two unbatched
    detect+describe passes; the reference processes the two images
    back-to-back, main.cpp:199-205).  Identical to two
    ``detect_and_compute`` calls.

    Returns (features_a, features_b).
    """
    return (detect_and_compute(image_a, plan, fixed),
            detect_and_compute(image_b, plan, fixed))


class Akaze:
    """Convenience wrapper that caches plans and compiled programs per
    image shape (the reference reuses its octave scratch the same way,
    akaze.cpp:109-118)."""

    def __init__(self, config: Optional[AkazeConfig] = None,
                 fixed: bool = False, mesh=None,
                 spatial_fallback: bool = False):
        """``mesh``: optional ``jax.sharding.Mesh`` with a ``data`` axis of
        more than one device — detection then row-shards each image over
        it (the oversized-image spatial tier, parallel/spatial.py) with
        the same cached-program ergonomics as the single-chip path.

        ``spatial_fallback``: with a mesh, shapes the spatial tier cannot
        shard (too small / odd octave splits) fall back to the single-chip
        program instead of raising — for callers feeding mixed frame sizes
        (e.g. the SLAM front-end under a mesh)."""
        self.config = config or AkazeConfig()
        self.fixed = fixed
        self.spatial_fallback = spatial_fallback
        if mesh is not None and "data" not in mesh.shape:
            raise ValueError(
                f"mesh axes {tuple(mesh.shape)} have no 'data' axis — the "
                "spatial tier shards image rows over mesh['data']")
        self.mesh = mesh if (mesh is not None
                             and mesh.shape["data"] > 1) else None
        self._plans = {}
        self._fns = {}

    def plan_for(self, height: int, width: int) -> PipelinePlan:
        key = (height, width)
        if key not in self._plans:
            self._plans[key] = build_plan(height, width, self.config)
        return self._plans[key]

    def _fn_for(self, height: int, width: int, describe: bool):
        key = (height, width, describe)
        if key not in self._fns:
            plan = self.plan_for(height, width)
            if self.mesh is not None:
                from .parallel.spatial import spatial_supported
                n_dev = self.mesh.shape["data"]
                ok, why = spatial_supported(plan, n_dev, detect=True,
                                            describe=describe)
                if not ok and not self.spatial_fallback:
                    raise ValueError(f"spatial sharding unsupported for "
                                     f"{height}x{width} over {n_dev} "
                                     f"devices: {why}")
                if ok:
                    self._fns[key] = partial(
                        _jit_spatial_detect_and_compute, plan=plan,
                        mesh=self.mesh, fixed=self.fixed, describe=describe)
                else:
                    self._fns[key] = partial(_jit_detect_and_compute,
                                             plan=plan, fixed=self.fixed,
                                             describe=describe)
            else:
                self._fns[key] = partial(_jit_detect_and_compute,
                                         plan=plan, fixed=self.fixed,
                                         describe=describe)
        return self._fns[key]

    def detect_and_compute(self, image, describe: bool = True) -> Features:
        """image: [H, W] numpy/JAX array.

        Float path expects values in [0, 1] (the demo divides by 255,
        main.cpp:149-150); the fixed path expects raw uint8 values 0..255
        (main.cpp:257-258).
        """
        image = jnp.asarray(image)
        if self.fixed:
            image = image.astype(jnp.int32)
        else:
            image = image.astype(jnp.float32)
        h, w = image.shape
        return self._fn_for(h, w, describe)(image)

    def detect_and_compute_pair(self, image_a, image_b):
        """Both images of a pair through one program (see
        ``detect_and_compute_pair``).  Returns (features_a, features_b).

        With a mesh, each image runs the row-sharded spatial program
        instead (per-image device memory is the reason the mesh exists;
        putting the pair onto one device would defeat it)."""
        conv = (lambda im: jnp.asarray(im).astype(
            jnp.int32 if self.fixed else jnp.float32))
        a, b = conv(image_a), conv(image_b)
        assert a.shape == b.shape, "pair batching needs equal shapes"
        if self.mesh is not None:
            fn = self._fn_for(*a.shape, True)
            return fn(a), fn(b)
        plan = self.plan_for(*a.shape)
        return _jit_detect_and_compute_pair(a, b, plan=plan,
                                            fixed=self.fixed)

    @staticmethod
    def match(f1: Features, f2: Features, max_dist: int = 96) -> Matches:
        """Brute-force Hamming match of f1 against f2 (cuMatch,
        akaze.cpp:55-64)."""
        return _jit_match(f1.words, f1.valid, f2.words, f2.valid,
                          f2.x, f2.y, max_dist)


@partial(jax.jit, static_argnums=(6,))
def _jit_match(w1, v1, w2, v2, x2, y2, max_dist):
    return match(w1, v1, w2, v2, x2, y2, max_dist)


# module-level jit entry: plans are frozen (hashable) dataclasses, so every
# Akaze instance with the same (shape, config) shares one compiled program
# (per-instance jax.jit wrappers were recompiling identical pipelines,
# which dominated the CPU test suite's wall time)
@partial(jax.jit, static_argnames=("plan", "fixed", "describe"))
def _jit_detect_and_compute(image, plan, fixed, describe):
    return detect_and_compute(image, plan, fixed, describe)


# Mesh is hashable, so the row-sharded program shares one compilation
# across Akaze instances exactly like the single-chip wrapper above
@partial(jax.jit, static_argnames=("plan", "mesh", "fixed", "describe"))
def _jit_spatial_detect_and_compute(image, plan, mesh, fixed, describe):
    from .parallel.spatial import spatial_detect_and_compute
    return spatial_detect_and_compute(image, plan, mesh, fixed=fixed,
                                      describe=describe)


@partial(jax.jit, static_argnames=("plan", "fixed"))
def _jit_detect_and_compute_pair(image_a, image_b, plan, fixed):
    return detect_and_compute_pair(image_a, image_b, plan, fixed)


def features_to_numpy(f: Features) -> dict:
    """Host-side export: trims to the live count (the strided AoS copyback,
    akaze.cpp:134-139)."""
    n = int(f.count)
    out = {k: np.asarray(v)[:n] for k, v in f._asdict().items()
           if k not in ("count", "overflow")}
    out["count"] = n
    out["overflow"] = bool(f.overflow)
    return out
