"""Row-sharded (spatial) scale space: halo-exchange exactness.

The sharded build must reproduce the unsharded ``build_scale_space``:
every stencil sees either genuine neighbour rows or exactly the rows
reflect-101 padding would synthesize, and the contrast percentile reduces
the same global histogram (reference semantics akaze.cpp:300-439,
akazed.cu:2410-2484).

The 16.16 fixed path is asserted BIT-EXACT — integer arithmetic admits no
rounding, so any seam/halo off-by-one would show up as large integer
mismatches.  The float path is held to 1e-5: XLA fuses the same stencil
expressions with different FMA contraction inside the shard_map program
(measured <= 2e-7, confined to ulp-level noise; the worst rows are the
global border rows where edge epilogues vectorize differently).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from akaze_jax import AkazeConfig
from akaze_jax.plan import build_plan
from akaze_jax.scale_space import build_scale_space
from akaze_jax.pipeline import detect_and_compute
from akaze_jax.parallel import (make_mesh, spatial_scale_space,
                                spatial_supported,
                                spatial_detect_and_compute)


@pytest.fixture(scope="module")
def mesh8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")
    return make_mesh(8)


def _parity(img, cfg, mesh, fixed, n_dev):
    plan = build_plan(*img.shape, cfg)
    ok, why = spatial_supported(plan, n_dev)
    assert ok, why
    ref_oct, ref_kc = jax.jit(
        lambda x: build_scale_space(x, plan, fixed=fixed))(img)
    sp_oct, sp_kc = jax.jit(
        lambda x: spatial_scale_space(x, plan, mesh, fixed=fixed))(img)
    assert np.asarray(ref_kc) == np.asarray(sp_kc)
    for a, b in zip(ref_oct, sp_oct):
        for name in ("L", "det", "lx", "ly"):
            ra = np.asarray(getattr(a, name))
            rb = np.asarray(getattr(b, name))
            if fixed:
                np.testing.assert_array_equal(ra, rb, err_msg=name)
            else:
                np.testing.assert_allclose(ra, rb, rtol=0, atol=1e-5,
                                           err_msg=name)


def test_spatial_scale_space_bit_parity_float(mesh8, rng):
    img = jnp.asarray(rng.random((256, 320)).astype(np.float32))
    _parity(img, AkazeConfig(), mesh8, False, 8)


def test_spatial_scale_space_bit_parity_fixed(mesh8, rng):
    img = jnp.asarray((rng.random((256, 320)) * 255).astype(np.int32))
    _parity(img, AkazeConfig(), mesh8, True, 8)


def _blob_image(rng, h, w):
    """Random 8x8 blobs + noise: enough structure for real keypoints."""
    base = rng.random((h // 8, w // 8)).astype(np.float32)
    img = np.kron(base, np.ones((8, 8), np.float32))
    img += 0.05 * rng.random((h, w)).astype(np.float32)
    return jnp.asarray(np.clip(img, 0, 1))


def test_spatial_detect_parity(mesh8, rng):
    """Row-sharded detection == unsharded: same keypoints, same order.

    Every stage (extrema, NMS, selection, refinement) sees genuine
    neighbour ghost rows or the exact constant fill the unsharded pads
    use, so positions/sizes/layers/responses must be identical."""
    img = _blob_image(rng, 256, 320)
    cfg = AkazeConfig(max_pts=512)
    plan = build_plan(256, 320, cfg)
    ok, why = spatial_supported(plan, 8, detect=True)
    assert ok, why
    ref = jax.jit(lambda x: detect_and_compute(x, plan,
                                               describe=False))(img)
    sp = jax.jit(lambda x: spatial_detect_and_compute(
        x, plan, mesh8, describe=False))(img)
    n = int(ref.count)
    assert int(sp.count) == n and n > 100
    for f in ("x", "y", "size", "layer", "response"):
        np.testing.assert_array_equal(np.asarray(getattr(ref, f))[:n],
                                      np.asarray(getattr(sp, f))[:n],
                                      err_msg=f)


def test_spatial_detect_parity_fixed(mesh8, rng):
    """Fixed (16.16) row-sharded detection is bit-exact vs unsharded."""
    img = (np.asarray(_blob_image(rng, 256, 320)) * 255).astype(np.int32)
    img = jnp.asarray(img)
    cfg = AkazeConfig(max_pts=512)
    plan = build_plan(256, 320, cfg)
    ref = jax.jit(lambda x: detect_and_compute(
        x, plan, fixed=True, describe=False))(img)
    sp = jax.jit(lambda x: spatial_detect_and_compute(
        x, plan, mesh8, fixed=True, describe=False))(img)
    n = int(ref.count)
    assert int(sp.count) == n and n > 50
    for f in ("x", "y", "size", "layer", "response"):
        np.testing.assert_array_equal(np.asarray(getattr(ref, f))[:n],
                                      np.asarray(getattr(sp, f))[:n],
                                      err_msg=f)


def test_spatial_describe_parity(rng):
    """Row-sharded full front-end == unsharded, descriptor bits included.

    Tall 1024x160 image over 4 devices so every shard holds keypoints and
    descriptor windows straddle the seams."""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 (virtual) devices")
    img = _blob_image(rng, 1024, 160)
    cfg = AkazeConfig(max_pts=512)
    plan = build_plan(1024, 160, cfg)
    ok, why = spatial_supported(plan, 4, detect=True, describe=True)
    assert ok, why
    mesh = make_mesh(4)
    ref = jax.jit(lambda x: detect_and_compute(x, plan))(img)
    sp = jax.jit(lambda x: spatial_detect_and_compute(x, plan, mesh))(img)
    n = int(ref.count)
    assert int(sp.count) == n and n > 100
    np.testing.assert_array_equal(np.asarray(ref.x)[:n],
                                  np.asarray(sp.x)[:n])
    np.testing.assert_array_equal(np.asarray(ref.y)[:n],
                                  np.asarray(sp.y)[:n])
    np.testing.assert_allclose(np.asarray(ref.angle)[:n],
                               np.asarray(sp.angle)[:n], atol=1e-6)
    wa = np.asarray(ref.words)[:n].view(np.uint8)
    wb = np.asarray(sp.words)[:n].view(np.uint8)
    assert np.unpackbits(wa ^ wb).sum() == 0


def test_spatial_describe_parity_gathered_octaves(rng):
    """Octaves too thin for the 64-row sampling halo are all-gathered whole;
    descriptors must still match the unsharded path exactly.  512x160 over
    4 devices: octave 0 halo-exchanges (128 rows/dev), octaves 1-2 (64/32
    rows/dev < 65) take the gather path."""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 (virtual) devices")
    img = _blob_image(rng, 512, 160)
    cfg = AkazeConfig(max_pts=512, noctaves=3)
    plan = build_plan(512, 160, cfg)
    ok, why = spatial_supported(plan, 4, detect=True, describe=True)
    assert ok, why
    mesh = make_mesh(4)
    ref = jax.jit(lambda x: detect_and_compute(x, plan))(img)
    sp = jax.jit(lambda x: spatial_detect_and_compute(x, plan, mesh))(img)
    n = int(ref.count)
    assert int(sp.count) == n and n > 50
    np.testing.assert_array_equal(np.asarray(ref.x)[:n],
                                  np.asarray(sp.x)[:n])
    np.testing.assert_array_equal(np.asarray(ref.layer)[:n],
                                  np.asarray(sp.layer)[:n])
    # keypoints must actually live on gathered octaves for the test to
    # mean anything
    assert (np.asarray(ref.layer)[:n] // cfg.max_scale).max() >= 1
    wa = np.asarray(ref.words)[:n].view(np.uint8)
    wb = np.asarray(sp.words)[:n].view(np.uint8)
    assert np.unpackbits(wa ^ wb).sum() == 0


def test_spatial_describe_parity_fixed(rng):
    """Fixed (16.16) row-sharded full front-end == unsharded, descriptor
    bits included, over both the halo-exchange (octave 0) and whole-gather
    (octaves 1-2) sampling paths."""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 (virtual) devices")
    img = (np.asarray(_blob_image(rng, 512, 160)) * 255).astype(np.int32)
    img = jnp.asarray(img)
    cfg = AkazeConfig(max_pts=512, noctaves=3)
    plan = build_plan(512, 160, cfg)
    mesh = make_mesh(4)
    ref = jax.jit(lambda x: detect_and_compute(x, plan, fixed=True))(img)
    sp = jax.jit(lambda x: spatial_detect_and_compute(
        x, plan, mesh, fixed=True))(img)
    n = int(ref.count)
    assert int(sp.count) == n and n > 50
    assert (np.asarray(ref.layer)[:n] // cfg.max_scale).max() >= 1
    np.testing.assert_array_equal(np.asarray(ref.y)[:n],
                                  np.asarray(sp.y)[:n])
    np.testing.assert_array_equal(np.asarray(ref.angle)[:n],
                                  np.asarray(sp.angle)[:n])
    wa = np.asarray(ref.words)[:n].view(np.uint8)
    wb = np.asarray(sp.words)[:n].view(np.uint8)
    assert np.unpackbits(wa ^ wb).sum() == 0


def test_spatial_supports_stock_shape_describe():
    """The flagship 960x1280 shape row-shards over 4 devices with full
    description (octaves 2-3 gather)."""
    plan = build_plan(960, 1280, AkazeConfig())
    ok, why = spatial_supported(plan, 4, detect=True, describe=True)
    assert ok, why


def test_akaze_wrapper_mesh(rng):
    """Akaze(mesh=...) routes detection through the spatial tier with the
    wrapper's cached-program ergonomics; results match the meshless
    wrapper."""
    if len(jax.devices()) < 2:
        pytest.skip("needs 2 (virtual) devices")
    from akaze_jax import Akaze
    img = np.asarray(_blob_image(rng, 160, 200))
    cfg = AkazeConfig(max_pts=512)
    ref = Akaze(cfg).detect_and_compute(img)
    sp = Akaze(cfg, mesh=make_mesh(2)).detect_and_compute(img)
    n = int(ref.count)
    assert int(sp.count) == n and n > 20
    np.testing.assert_array_equal(np.asarray(ref.x)[:n],
                                  np.asarray(sp.x)[:n])
    wa = np.asarray(ref.words)[:n].view(np.uint8)
    wb = np.asarray(sp.words)[:n].view(np.uint8)
    assert np.unpackbits(wa ^ wb).sum() == 0

    # pair entry point routes each image through the spatial program
    # (instead of silently ignoring the mesh)
    img_b = np.asarray(_blob_image(rng, 160, 200))
    ra, rb = Akaze(cfg).detect_and_compute_pair(img, img_b)
    sa, sb = Akaze(cfg, mesh=make_mesh(2)).detect_and_compute_pair(
        img, img_b)
    assert int(sa.count) == int(ra.count)
    assert int(sb.count) == int(rb.count)
    np.testing.assert_array_equal(
        np.asarray(rb.x)[:int(rb.count)], np.asarray(sb.x)[:int(rb.count)])

    with pytest.raises(ValueError, match="unsupported"):
        # 960x1280 over 8 devices: octave-3 blocks too thin
        Akaze(cfg, mesh=make_mesh(8)).detect_and_compute(
            np.zeros((960, 1280), np.float32))

    with pytest.raises(ValueError, match="data"):
        from jax.sharding import Mesh
        Akaze(cfg, mesh=Mesh(np.array(jax.devices()[:2]), ("x",)))


def test_spatial_supported_rejects_thin_blocks():
    cfg = AkazeConfig()
    plan = build_plan(960, 1280, cfg)
    ok, why = spatial_supported(plan, 8)   # octave 3: 15 local rows
    assert not ok and "halo" in why
    ok4, _ = spatial_supported(plan, 4)
    assert ok4

    with pytest.raises(ValueError, match="unsupported"):
        spatial_scale_space(jnp.zeros((960, 1280), jnp.float32), plan,
                            make_mesh(8))
