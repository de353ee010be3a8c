import numpy as np
import jax.numpy as jnp

from akaze_jax.match import hamming_distance_matrix, match

import golden


def _pack(bits486, n):
    """[n, 486] bool -> [n, 16] uint32 little-endian."""
    b = np.zeros((n, 512), np.uint8)
    b[:, :486] = bits486
    return np.packbits(b, axis=1, bitorder="little").view(np.uint32)


def test_hamming_matrix_exact():
    rng = np.random.default_rng(0)
    b1 = rng.integers(0, 2, (37, 486)).astype(np.uint8)
    b2 = rng.integers(0, 2, (53, 486)).astype(np.uint8)
    w1, w2 = _pack(b1, 37), _pack(b2, 53)
    d = np.asarray(hamming_distance_matrix(jnp.asarray(w1), jnp.asarray(w2)))
    ref = (b1[:, None, :] != b2[None, :, :]).sum(-1)
    np.testing.assert_array_equal(d.astype(np.int32), ref)


def test_match_identity_and_threshold():
    rng = np.random.default_rng(1)
    bits = rng.integers(0, 2, (20, 486)).astype(np.uint8)
    w = jnp.asarray(_pack(bits, 20))
    valid = jnp.ones(20, bool)
    x = jnp.arange(20.0)
    y = jnp.arange(20.0) + 100
    m = match(w, valid, w, valid, x, y, max_dist=96)
    np.testing.assert_array_equal(np.asarray(m.index), np.arange(20))
    np.testing.assert_array_equal(np.asarray(m.distance), np.zeros(20))
    np.testing.assert_array_equal(np.asarray(m.match_x), np.arange(20))


def test_match_rejects_non_unique_minimum():
    # duplicate train descriptors -> two equal minima -> reject
    rng = np.random.default_rng(2)
    bits = rng.integers(0, 2, (4, 486)).astype(np.uint8)
    train = np.vstack([bits, bits[:1]])  # descriptor 0 duplicated at index 4
    wq = jnp.asarray(_pack(bits, 4))
    wt = jnp.asarray(_pack(train, 5))
    valid_q = jnp.ones(4, bool)
    valid_t = jnp.ones(5, bool)
    x = jnp.arange(5.0)
    m = match(wq, valid_q, wt, valid_t, x, x, max_dist=96)
    assert int(m.index[0]) == -1          # ambiguous -> rejected
    assert int(m.index[1]) == 1           # unique -> kept


def test_match_respects_max_dist():
    bits = np.zeros((2, 486), np.uint8)
    bits[1, :120] = 1  # distance 120 > 96
    wq = jnp.asarray(_pack(bits[:1], 1))
    wt = jnp.asarray(_pack(bits[1:], 1))
    one = jnp.ones(1, bool)
    m = match(wq, one, wt, one, jnp.zeros(1), jnp.zeros(1), max_dist=96)
    assert int(m.index[0]) == -1
    m = match(wq, one, wt, one, jnp.zeros(1), jnp.zeros(1), max_dist=128)
    assert int(m.index[0]) == 0


def test_match_ignores_invalid_train():
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 2, (3, 486)).astype(np.uint8)
    wq = jnp.asarray(_pack(bits[:1], 1))
    wt = jnp.asarray(_pack(bits, 3))
    # the identical descriptor (index 0) is invalid -> match should not pick it
    valid_t = jnp.asarray([False, True, True])
    m = match(wq, jnp.ones(1, bool), wt, valid_t,
              jnp.arange(3.0), jnp.arange(3.0), max_dist=486)
    assert int(m.index[0]) != 0


class TestPallasMatcher:
    def test_interpret_matches_xla(self, rng):
        from akaze_jax.match import match
        import jax.numpy as jnp
        n1, n2 = 200, 300   # deliberately not multiples of 128
        w1 = rng.integers(0, 2**32, (n1, 16), dtype=np.uint64).astype(
            np.uint32)
        w2 = rng.integers(0, 2**32, (n2, 16), dtype=np.uint64).astype(
            np.uint32)
        w1[:, 15] &= np.uint32((1 << 6) - 1)
        w2[:, 15] &= np.uint32((1 << 6) - 1)
        # plant near-duplicates so some matches pass max_dist, including a
        # tie pair that must be rejected by the uniqueness rule
        w2[10] = w1[3]
        w2[20] = w1[7]
        w2[21] = w1[7]      # exact tie -> best == second -> reject
        v1 = np.ones(n1, bool); v1[5] = False
        v2 = np.ones(n2, bool); v2[10] = True; v2[30] = False
        x2 = rng.uniform(0, 100, n2).astype(np.float32)
        y2 = rng.uniform(0, 100, n2).astype(np.float32)
        args = (jnp.asarray(w1), jnp.asarray(v1), jnp.asarray(w2),
                jnp.asarray(v2), jnp.asarray(x2), jnp.asarray(y2), 96)
        ref = match(*args, use_pallas="off")
        pal = match(*args, use_pallas="interpret")
        np.testing.assert_array_equal(np.asarray(ref.index),
                                      np.asarray(pal.index))
        np.testing.assert_array_equal(np.asarray(ref.distance),
                                      np.asarray(pal.distance))
        assert int(ref.index[3]) == 10
        assert int(ref.index[7]) == -1  # tie rejected

    def test_non_prefix_validity(self, rng):
        """Gathered multi-source train sets have prefix-per-shard (not
        global-prefix) validity; the kernel must scan to the LAST live row,
        not sum(valid) rows (r2 verdict: latent wrong-match bug)."""
        import jax.numpy as jnp
        n1, n2 = 256, 1152  # live train rows beyond ceil(sum/TB) blocks
        w1 = rng.integers(0, 2**32, (n1, 16), dtype=np.uint64).astype(
            np.uint32)
        w2 = rng.integers(0, 2**32, (n2, 16), dtype=np.uint64).astype(
            np.uint32)
        w1[:, 15] &= np.uint32((1 << 6) - 1)
        w2[:, 15] &= np.uint32((1 << 6) - 1)
        v1 = np.zeros(n1, bool)
        v1[:50] = True
        v1[200] = True              # live query beyond sum(valid1)=51
        v2 = np.zeros(n2, bool)
        v2[:100] = True             # shard-0 prefix
        v2[1100:1150] = True        # shard-N prefix: sum(valid2)=150 < 512
        w2[1100] = w1[200]          # its match lives in the far tail
        w2[1120] = w1[3]
        x2 = np.arange(n2, dtype=np.float32)
        y2 = x2 + 0.5
        args = (jnp.asarray(w1), jnp.asarray(v1), jnp.asarray(w2),
                jnp.asarray(v2), jnp.asarray(x2), jnp.asarray(y2), 96)
        ref = match(*args, use_pallas="off")
        pal = match(*args, use_pallas="interpret")
        assert int(ref.index[200]) == 1100
        assert int(ref.index[3]) == 1120
        np.testing.assert_array_equal(np.asarray(ref.index),
                                      np.asarray(pal.index))
        np.testing.assert_array_equal(np.asarray(ref.distance),
                                      np.asarray(pal.distance))
