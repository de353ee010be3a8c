"""Pallas kernel (Triton route): brute-force Hamming 1-NN with running top-2.

The XLA matcher (match.py) materialises the full [N1, N2] f32 distance
matrix in device memory (~400 MB at the 10k slot capacity), reads it back
for min / argmin / masked-second, and scans every slot.  This kernel follows
the reference's gHammingMatch (one block per query tile, a running minimum,
no distance matrix) but puts the distances on the tensor cores: each program
takes BQ queries, loops over BT-row train tiles up to the live train extent,
and keeps the running (best, second, arg-best) in registers.  Query tiles
past the live query extent exit at once.

Distances use the signed-bits identity of match.py:
    hamming(a, b) = (486 - <sa, sb>) / 2
with sa, sb in {-1, 0, +1} as bf16 and f32 accumulation (exact).  A per-row
f32 bias adds 1e6 to invalid train rows, as the XLA path does, and 1e9 to
the padding rows, so the kernel's distances over the rows it scans equal the
XLA path's for any ``max_dist``.

Tie semantics equal ``jnp.argmin`` + masked second minimum: the first global
minimum wins; equal top-2 values give best == second (rejected upstream).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

# queries per program and train rows per inner iteration: the bf16 query
# tile and num_stages=2 train tiles take 64 + 2 * 64 KB of the 227 KB of
# shared memory a block may use on Hopper
BQ = 64
BT = 64
LANES = 512       # descriptor lanes (486 live bits)
BITS = 486.0
BIG = 1.0e9
INVALID = 1.0e6   # the XLA path's bias on invalid train rows (match.py)


def _kernel(counts_ref,   # [2] i32: query / train last-live-row + 1
            q_ref,        # [BQ, LANES] bf16 query signed bits
            t_ref,        # [N2, LANES] bf16 train signed bits (whole set)
            bias_ref,     # [N2] f32 train row bias: 0 live, 1e6 invalid
            best_ref,     # out [BQ] f32
            second_ref,   # out [BQ] f32
            idx_ref):     # out [BQ] i32
    n_tiles = t_ref.shape[0] // BT
    init = (jnp.full((BQ,), BIG, jnp.float32),
            jnp.full((BQ,), BIG, jnp.float32),
            jnp.full((BQ,), -1, jnp.int32))

    def scan_train():
        q = q_ref[...]

        def body(j, carry):
            best, second, idx = carry
            rows = pl.ds(pl.multiple_of(j * BT, BT), BT)
            d = (0.5 * (BITS - pl.dot(q, t_ref[rows, :], trans_b=True))
                 + bias_ref[rows][None, :])                       # [BQ, BT]
            col = jax.lax.broadcasted_iota(jnp.int32, (BQ, BT), 1)
            m1 = jnp.min(d, axis=1)
            i1 = jnp.min(jnp.where(d == m1[:, None], col, BT), axis=1)
            m2 = jnp.min(jnp.where(col == i1[:, None], BIG, d), axis=1)
            # merge (strict < keeps the earlier tile's index on ties; equal
            # minima collapse to best == second, as in the XLA path)
            return (jnp.minimum(best, m1),
                    jnp.minimum(jnp.maximum(best, m1),
                                jnp.minimum(second, m2)),
                    jnp.where(m1 < best, j * BT + i1, idx))

        live_tiles = jnp.minimum(pl.cdiv(counts_ref[1], BT), n_tiles)
        return jax.lax.fori_loop(0, live_tiles, body, init)

    q_live = pl.program_id(0) * BQ < counts_ref[0]
    best, second, idx = jax.lax.cond(q_live, scan_train, lambda: init)
    best_ref[...] = best
    second_ref[...] = second
    idx_ref[...] = idx


@partial(jax.jit, static_argnames=("interpret",))
def hamming_top2(s1, s2, valid2, count1, count2, interpret: bool = False):
    """Running-top-2 Hamming matcher.

    Args:
      s1: [N1, 512] bf16 signed query bits.
      s2: [N2, 512] bf16 signed train bits.
      valid2: [N2] bool train validity; invalid rows score distance + 1e6.
      count1/count2: index of the last live row + 1 of each set (the live
        count for prefix-compacted sets); work scales with these extents
        instead of the slot capacities.
      interpret: run in the Pallas interpreter (CPU tests).

    Returns (best [N1] f32, second [N1] f32, index [N1] i32); queries at or
    past ``count1`` get (1e9, 1e9, -1).
    """
    n1, n2 = s1.shape[0], s2.shape[0]
    p1, p2 = (-n1) % BQ, (-n2) % BT
    if p1:
        s1 = jnp.pad(s1, ((0, p1), (0, 0)))
    bias = jnp.where(valid2, 0.0, INVALID).astype(jnp.float32)
    if p2:
        s2 = jnp.pad(s2, ((0, p2), (0, 0)))
        bias = jnp.pad(bias, (0, p2), constant_values=BIG)
    counts = jnp.stack([jnp.asarray(count1, jnp.int32),
                        jnp.asarray(count2, jnp.int32)])
    n1p = n1 + p1
    vec = pl.BlockSpec((BQ,), lambda i: (i,))
    best, second, idx = pl.pallas_call(
        _kernel,
        out_shape=(jax.ShapeDtypeStruct((n1p,), jnp.float32),
                   jax.ShapeDtypeStruct((n1p,), jnp.float32),
                   jax.ShapeDtypeStruct((n1p,), jnp.int32)),
        grid=(n1p // BQ,),
        in_specs=[pl.BlockSpec((2,), lambda i: (0,)),
                  pl.BlockSpec((BQ, LANES), lambda i: (i, 0)),
                  pl.BlockSpec((n2 + p2, LANES), lambda i: (0, 0)),
                  pl.BlockSpec((n2 + p2,), lambda i: (0,))],
        out_specs=(vec, vec, vec),
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=4, num_stages=2),
        interpret=interpret,
        name="hamming_top2",
    )(counts, s1, s2, bias)
    return best[:n1], second[:n1], idx[:n1]
