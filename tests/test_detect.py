import numpy as np
import jax.numpy as jnp

from akaze_jax import AkazeConfig
from akaze_jax.plan import build_plan
from akaze_jax.detect import (FMIN_VAL, Keypoints, nms, select_keypoints,
                              refine_keypoints, flatten_pyramid)
from akaze_jax.scale_space import OctaveData


def _maps(h, w, pts):
    """Build full-res maps with given (y, x, resp, size, layer) points."""
    resp = np.full((h, w), FMIN_VAL, np.float32)
    size = np.zeros((h, w), np.float32)
    layer = np.full((h, w), -1, np.int32)
    for y, x, r, s, l in pts:
        resp[y, x] = r
        size[y, x] = s
        layer[y, x] = l
    return jnp.asarray(resp), jnp.asarray(size), jnp.asarray(layer)


def _plan(h=200, w=200):
    return build_plan(h, w, AkazeConfig(max_pts=64, noctaves=1))


def test_nms_suppresses_weaker_neighbor():
    plan = _plan()
    r, s, l = _maps(200, 200, [(100, 100, 5.0, 2.4, 0),
                               (101, 101, 4.0, 2.4, 0)])
    mask = np.asarray(nms(r, s, l, plan))
    assert mask[100, 100] and not mask[101, 101]


def test_nms_tie_break_keeps_top_left():
    # equal responses: the reference suppresses a point whose equal neighbor
    # lies in its top-left quadrant (akazed.cu:1586-1588), so the top-left
    # point of an equal pair survives
    plan = _plan()
    r, s, l = _maps(200, 200, [(100, 100, 5.0, 2.4, 0),
                               (101, 101, 5.0, 2.4, 0)])
    mask = np.asarray(nms(r, s, l, plan))
    assert mask[100, 100] and not mask[101, 101]


def test_nms_anti_diagonal_ties_both_survive():
    plan = _plan()
    r, s, l = _maps(200, 200, [(100, 101, 5.0, 2.4, 0),
                               (101, 100, 5.0, 2.4, 0)])
    mask = np.asarray(nms(r, s, l, plan))
    assert mask[100, 101] and mask[101, 100]


def test_nms_radius_respects_truncated_square():
    # size 2.4 -> int sqsz = 5; offset (1, 2) has d2 = 5 which is NOT < 5,
    # so a stronger neighbor there must not suppress
    plan = _plan()
    r, s, l = _maps(200, 200, [(100, 100, 5.0, 2.4, 0),
                               (101, 102, 9.0, 2.4, 0)])
    mask = np.asarray(nms(r, s, l, plan))
    assert mask[100, 100] and mask[101, 102]
    # offset (1, 1) has d2 = 2 < 5 -> suppressed
    r, s, l = _maps(200, 200, [(100, 100, 5.0, 2.4, 0),
                               (101, 101, 9.0, 2.4, 0)])
    mask = np.asarray(nms(r, s, l, plan))
    assert not mask[100, 100]


def test_nms_border_region():
    plan = _plan()
    psz = plan.psz
    r, s, l = _maps(200, 200, [(psz - 1, 50, 5.0, 2.4, 0),
                               (psz, 120, 5.0, 2.4, 0),
                               (40, 200 - psz - 1, 5.0, 2.4, 0),
                               (160, 200 - psz, 5.0, 2.4, 0)])
    mask = np.asarray(nms(r, s, l, plan))
    assert not mask[psz - 1, 50] and mask[psz, 120]
    assert mask[40, 200 - psz - 1] and not mask[160, 200 - psz]


def test_select_keypoints_compacts_row_major():
    plan = _plan()
    pts = [(60, 60, 5.0, 2.4, 0), (60, 120, 4.0, 2.9, 1),
           (120, 60, 3.0, 3.4, 2)]
    r, s, l = _maps(200, 200, pts)
    mask = nms(r, s, l, plan)
    kps = select_keypoints(mask, r, s, l, 64)
    assert int(kps.count) == 3
    np.testing.assert_array_equal(np.asarray(kps.x[:3]), [60, 120, 60])
    np.testing.assert_array_equal(np.asarray(kps.y[:3]), [60, 60, 120])
    np.testing.assert_array_equal(np.asarray(kps.layer[:3]), [0, 1, 2])
    assert not bool(kps.valid[3])


def test_select_keypoints_overflow_flag():
    """Dropped survivors must be signalled: a row overflowing ROW_CAP or a
    total beyond max_pts sets kps.overflow (the reference clamps silently,
    akaze.cpp:451)."""
    from akaze_jax.detect import ROW_CAP
    h, w = 64, 200
    r = jnp.ones((h, w), jnp.float32)
    s = jnp.full((h, w), 2.4, jnp.float32)
    l = jnp.zeros((h, w), jnp.int32)

    # 1) no overflow
    m = np.zeros((h, w), bool)
    m[10, 20:25] = True
    kps = select_keypoints(jnp.asarray(m), r, s, l, 64)
    assert int(kps.count) == 5 and not bool(kps.overflow)

    # 2) one 128-lane tile with more than TILE_CAP survivors: tail
    #    dropped, flagged
    from akaze_jax.detect import TILE_CAP
    m = np.zeros((h, w), bool)
    m[10, 10:10 + TILE_CAP + 6] = True
    kps = select_keypoints(jnp.asarray(m), r, s, l, 128)
    assert int(kps.count) == TILE_CAP
    assert bool(kps.overflow)
    # kept survivors are the lowest columns, in order
    np.testing.assert_array_equal(np.asarray(kps.x[:TILE_CAP]),
                                  np.arange(10, 10 + TILE_CAP))

    # 2b) a row with more than ROW_CAP survivors spread across tiles
    #     (none over TILE_CAP): clamped at ROW_CAP, flagged
    w2 = 640
    m = np.zeros((h, w2), bool)
    m[10, ::16] = True           # 40 survivors, 8 per 128-lane tile
    r2 = jnp.ones((h, w2), jnp.float32)
    s2 = jnp.full((h, w2), 2.4, jnp.float32)
    l2 = jnp.zeros((h, w2), jnp.int32)
    kps = select_keypoints(jnp.asarray(m), r2, s2, l2, 128)
    assert int(kps.count) == ROW_CAP
    assert bool(kps.overflow)
    # the kept ROW_CAP are the lowest-column survivors, in order
    np.testing.assert_array_equal(np.asarray(kps.x[:ROW_CAP]),
                                  np.arange(0, 16 * ROW_CAP, 16))

    # 3) total beyond max_pts: clamped, flagged
    m = np.zeros((h, w), bool)
    m[5:25, 30] = True  # 20 survivors, one per row
    kps = select_keypoints(jnp.asarray(m), r, s, l, 8)
    assert int(kps.count) == 8
    assert bool(kps.overflow)


def test_refine_recovers_subpixel_peak():
    # build a det plane with a quadratic peak at (50.3, 40.6)
    cfg = AkazeConfig(max_pts=8, noctaves=1, max_scale=1)
    plan = build_plan(128, 128, cfg)
    yy, xx = np.mgrid[0:128, 0:128].astype(np.float32)
    det = 10.0 - (yy - 50.3) ** 2 - (xx - 40.6) ** 2
    oct0 = OctaveData(L=jnp.zeros((1, 128, 128)),
                      det=jnp.asarray(det[None]),
                      lx=jnp.zeros((1, 128, 128)),
                      ly=jnp.zeros((1, 128, 128)))
    flat = flatten_pyramid([oct0])
    kps = Keypoints(x=jnp.asarray([40.0] * 8), y=jnp.asarray([50.0] * 8),
                    size=jnp.full(8, 2.4), layer=jnp.zeros(8, jnp.int32),
                    response=jnp.zeros(8), valid=jnp.asarray([True] * 8),
                    count=jnp.int32(1))
    out = refine_keypoints(kps, flat, plan)
    assert abs(float(out.x[0]) - 40.6) < 1e-2
    assert abs(float(out.y[0]) - 50.3) < 1e-2


def test_odd_image_sizes_multi_octave(test_image):
    """Odd H/W with multiple octaves: the upsample merge must pad the
    expansion back to full resolution (a 201x333 image once crashed with a
    (200,332) vs (201,333) broadcast error)."""
    import jax.numpy as jnp
    from akaze_jax import AkazeConfig
    from akaze_jax.plan import build_plan
    from akaze_jax.pipeline import detect_and_compute

    img = test_image[:191, :255]  # odd, still >= 80 after one halving
    cfg = AkazeConfig(max_pts=256, noctaves=2)
    plan = build_plan(*img.shape, cfg)
    f = detect_and_compute(jnp.asarray(img), plan)
    assert int(f.count) >= 0
    import numpy as np
    assert np.isfinite(np.asarray(f.x)).all()
