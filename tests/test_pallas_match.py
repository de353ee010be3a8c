"""The Triton-route Hamming matcher (ops/pallas_match.py) in the Pallas
interpreter, against the XLA path and the numpy golden, and the matcher's
route selection (match.kernel_route)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

import golden
from akaze_jax.match import kernel_route, last_live, match, _signed_bits
from akaze_jax.ops.pallas_match import BQ, BT, hamming_top2


def _words(rng, n):
    w = rng.integers(0, 2 ** 32, (n, 16), dtype=np.uint64).astype(np.uint32)
    w[:, 15] &= np.uint32((1 << 6) - 1)     # zero the pad bits (> 486)
    return w


def _near(w, rng, flips):
    """A copy of descriptor ``w`` with ``flips`` random live bits flipped."""
    out = w.copy()
    for b in rng.choice(486, flips, replace=False):
        out[b // 32] ^= np.uint32(1 << (b % 32))
    return out


def _case(name, rng):
    """(w1, v1, w2, v2) for one validity/tie pattern."""
    n1, n2 = {"ragged": (200, 300), "all_invalid_train": (70, 130),
              "ties": (64, 256), "count1_zero": (100, 140),
              "gathered": (256, 1152), "tail": (BQ + 3, 2 * BT + 5)}[name]
    w1, w2 = _words(rng, n1), _words(rng, n2)
    v1, v2 = np.ones(n1, bool), np.ones(n2, bool)
    if name == "ragged":
        v1[150:] = False
        v2[233:] = False
        for q, t, f in ((3, 10, 0), (7, 200, 20), (40, 232, 60),
                        (41, 100, 95), (42, 101, 96)):
            w2[t] = _near(w1[q], rng, f)
    elif name == "all_invalid_train":
        w2[5] = w1[5]
        v2[:] = False
    elif name == "ties":
        w2[10] = w2[20] = w1[3]                 # exact tie -> reject
        w2[30] = _near(w1[4], rng, 5)
        w2[31] = _near(w1[4], rng, 5)           # tie at distance 5
        w2[40] = _near(w1[5], rng, 7)
        w2[200] = _near(w1[5], rng, 8)          # strictly second -> keep
    elif name == "count1_zero":
        v1[:] = False
        w2[0] = w1[0]
    elif name == "gathered":
        # prefix-per-shard validity, as after sharded_match's all_gather
        v2[:] = False
        for d in range(8):
            v2[d * 144:d * 144 + 20 + 3 * d] = True
        v1[:] = False
        v1[:50] = True
        v1[200] = True
        w2[1100] = w1[200]
        w2[1010] = _near(w1[3], rng, 12)
        w2[60] = w1[4]                          # dead row: must not match
    elif name == "tail":
        v1[:] = True
        w2[-1] = w1[-1]                         # live rows end exactly
        w2[BT] = _near(w1[0], rng, 3)           # at the padded extent
    return w1, v1, w2, v2


CASES = ["ragged", "all_invalid_train", "ties", "count1_zero", "gathered",
         "tail"]


@pytest.mark.parametrize("name", CASES)
def test_kernel_matches_xla_and_golden(name):
    rng = np.random.default_rng(CASES.index(name))
    w1, v1, w2, v2 = _case(name, rng)
    n2 = w2.shape[0]
    x2 = np.arange(n2, dtype=np.float32)
    args = (jnp.asarray(w1), jnp.asarray(v1), jnp.asarray(w2),
            jnp.asarray(v2), jnp.asarray(x2), jnp.asarray(x2 + 0.5), 96)
    ker = match(*args, use_pallas="interpret")
    xla = match(*args, use_pallas="off")
    g_idx, g_dist = golden.match(w1, v1, w2, v2, 96)
    for m in (ker, xla):
        np.testing.assert_array_equal(np.asarray(m.index), g_idx)
        np.testing.assert_array_equal(np.asarray(m.distance), g_dist)
    acc = g_idx >= 0
    np.testing.assert_array_equal(np.asarray(ker.match_x)[acc],
                                  x2[g_idx[acc]])
    if name in ("all_invalid_train", "count1_zero"):
        assert not acc.any()
    else:
        assert acc.sum() >= 1


@pytest.mark.parametrize("max_dist", [244, 300, 487])
def test_kernel_matches_xla_above_243_with_invalid_rows(max_dist):
    """Thresholds past the zero-row distance of 243: invalid train rows
    (here the nearest neighbours of some queries) must never be accepted,
    and the valid runner-up must be, on both routes."""
    rng = np.random.default_rng(max_dist)
    n1, n2 = 90, 3 * BT + 7
    w1, w2 = _words(rng, n1), _words(rng, n2)
    v1, v2 = np.ones(n1, bool), np.ones(n2, bool)
    v2[rng.choice(n2 - 20, 60, replace=False)] = False
    v2[-20:] = False                            # dead tail past the extent
    for q in range(0, n1, 3):
        t_bad, t_good = 2 * q, 2 * q + 1
        w2[t_bad] = _near(w1[q], rng, 1)
        v2[t_bad] = False
        w2[t_good] = _near(w1[q], rng, 4 + q % 7)
        v2[t_good] = True
    x2 = np.arange(n2, dtype=np.float32)
    args = (jnp.asarray(w1), jnp.asarray(v1), jnp.asarray(w2),
            jnp.asarray(v2), jnp.asarray(x2), jnp.asarray(x2), max_dist)
    ker = match(*args, use_pallas="interpret")
    xla = match(*args, use_pallas="off")
    g_idx, g_dist = golden.match(w1, v1, w2, v2, max_dist)
    for m in (ker, xla):
        np.testing.assert_array_equal(np.asarray(m.index), g_idx)
        np.testing.assert_array_equal(np.asarray(m.distance), g_dist)
    acc = g_idx >= 0
    assert acc.sum() >= n1 // 3 and v2[g_idx[acc]].all()


@pytest.mark.parametrize("counts", [(0, 0), (1, 1), (BQ + 1, BT - 1),
                                    (150, 2 * BT + 1)])
def test_hamming_top2_running_state(counts):
    """The raw kernel outputs: exact best / second / first arg-best over the
    live train extent for live query tiles, (1e9, 1e9, -1) past count1;
    invalid train rows score distance + 1e6."""
    rng = np.random.default_rng(7)
    n1, n2 = 150, 2 * BT + 1
    w1, w2 = _words(rng, n1), _words(rng, n2)
    w2[5] = w2[9] = _near(w1[2], rng, 3)        # tie on the best
    w2[11] = w1[7]                              # an invalid exact match
    v2 = np.ones(n2, bool)
    v2[[11, 40, 41]] = False
    c1, c2 = counts
    best, second, idx = hamming_top2(
        _signed_bits(jnp.asarray(w1)), _signed_bits(jnp.asarray(w2)),
        jnp.asarray(v2), c1, c2, interpret=True)
    best, second, idx = map(np.asarray, (best, second, idx))
    # the kernel scans whole BT-row tiles up to the one holding row c2 - 1
    # (rows past n2 are padding with a bias of 1e9)
    ext = -(-c2 // BT) * BT
    d = np.full((n1, ext), 1e9, np.float32)
    d[:, :min(ext, n2)] = (golden.hamming(w1, w2[:ext])
                           + np.where(v2[:ext], 0, 1e6))
    for q in range(n1):
        if (q // BQ) * BQ >= c1 or c2 == 0:
            assert (best[q], second[q], idx[q]) == (1e9, 1e9, -1)
            continue
        b = int(np.argmin(d[q]))
        assert idx[q] == b and best[q] == d[q, b]
        assert second[q] == np.min(np.delete(d[q], b))


def test_route_auto_on_cpu_is_xla():
    assert jax.default_backend() == "cpu"
    assert kernel_route("auto") == "xla"
    assert kernel_route("off") == "xla"
    assert kernel_route("interpret") == "interpret"
    w = jnp.zeros((8, 16), jnp.uint32)
    v = jnp.ones(8, bool)
    x = jnp.zeros(8)
    jaxpr = str(jax.make_jaxpr(lambda w: match(w, v, w, v, x, x))(w))
    assert "pallas_call" not in jaxpr


def test_route_on_off_gpu_raises():
    with pytest.raises(ValueError, match="GPU"):
        kernel_route("on")
    w = jnp.zeros((8, 16), jnp.uint32)
    v = jnp.ones(8, bool)
    with pytest.raises(ValueError, match="GPU"):
        match(w, v, w, v, jnp.zeros(8), jnp.zeros(8), use_pallas="on")
    with pytest.raises(ValueError, match="use_pallas"):
        kernel_route("bogus")


def test_last_live():
    v = jnp.asarray([True, False, True, False, False])
    assert int(last_live(v)) == 3
    assert int(last_live(jnp.zeros(4, bool))) == 0
