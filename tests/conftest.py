"""Test configuration: run everything on a virtual 8-device CPU mesh so the
suite is cluster-free (SURVEY.md §4) and sharding code paths are exercised
without accelerator hardware."""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

# override explicitly in case the environment pins another platform
jax.config.update("jax_platforms", "cpu")

# persistent compilation cache: the suite is compile-dominated; caching
# compiled programs across runs/processes cuts repeat wall time severalfold
from akaze_jax.profiling import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture()
def rng():
    """Fresh deterministic generator PER TEST: a session-scoped stream
    makes every test's data depend on which tests ran before it (adding a
    test reshuffles all downstream draws — an order-dependence that once
    flipped a RANSAC test), so each test draws from its own seed-42
    stream."""
    return np.random.default_rng(42)


@pytest.fixture(scope="session")
def test_image():
    """Small synthetic test image with blob structure (float in [0, 1])."""
    rng = np.random.default_rng(42)
    h, w = 192, 256
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.zeros((h, w))
    centers = rng.uniform(20, 170, size=(25, 2))
    centers[:, 1] = rng.uniform(20, 236, size=25)
    for (cy, cx), s, a in zip(centers, rng.uniform(2, 9, 25),
                              rng.uniform(0.3, 1.0, 25)):
        img += a * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s))
    img += 0.05 * rng.standard_normal((h, w))
    img = np.clip(img, 0, 1)
    return img.astype(np.float32)


@pytest.fixture(scope="session")
def stereo_pair():
    """A seeded textured pair at the reference's stock shape (960x1280
    uint8); the right image is the left shifted by (7, 13)."""
    from akaze_jax.io import synthetic_pair
    return synthetic_pair((960, 1280), (7, 13), seed=0)
