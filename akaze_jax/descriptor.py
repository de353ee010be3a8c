"""Keypoint orientation and MLDB binary descriptor.

Reference kernels: gCalcOrient (akazed.cu:1665-1736; fixed akazed.cu:3649-3720)
and gDescribe2 (akazed.cu:1869-2001; fixed akazed.cu:3723-3855), with the
comparison-index tables from setCompareIndices (akazed.cu:65-159).

Each keypoint reads its samples straight from its sublevel plane with
bounds-checked nearest-neighbour gathers, as the reference's per-thread
reads do; the cell sums and the 486 comparisons follow.

All sampling geometry (orientation disc, descriptor grid, cell memberships,
comparison pairs) is static given the config and lives in constant tables.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .config import DESCRIPTOR_BITS, DESCRIPTOR_WORDS
from .detect import FlatPyramid, Keypoints
from .plan import PipelinePlan

H_PI = math.pi / 2.0


def fast_atan2(y, x):
    """The reference's polynomial atan2 (dFastAtan2, akazed.cu:173-185)."""
    absx = jnp.abs(x)
    absy = jnp.abs(y)
    mx = jnp.maximum(absx, absy)
    mn = jnp.minimum(absx, absy)
    a = mn / jnp.where(mx == 0, 1.0, mx)
    s = a * a
    r = ((-0.0464964749 * s + 0.15931422) * s - 0.327622764) * s * a + a
    r = jnp.where(absy > absx, H_PI - r, r)
    r = jnp.where(x < 0, math.pi - r, r)
    r = jnp.where(y < 0, -r, r)
    return r


# --------------------------------------------------------------------------
# static tables
# --------------------------------------------------------------------------

@lru_cache(maxsize=None)
def _orient_grid():
    """11x11 grid (i, j in [-5, 5]) with the r^2 < 36 disc mask and Gaussian
    weights exp(-r^2 * 0.08) (akazed.cu:1692-1697)."""
    wt = np.zeros((11, 11), np.float32)
    for a in range(11):       # row index -> j (vertical offset)
        for b in range(11):   # col index -> i (horizontal offset)
            j, i = a - 5, b - 5
            r2 = i * i + j * j
            if r2 < 36:
                wt[a, b] = math.exp(-r2 * 0.08)
    return wt


@lru_cache(maxsize=None)
def _descriptor_window(patsize: int):
    """Static window geometry of gDescribe2 (akazed.cu:1910-1954).

    Returns (l, k, membership M [winsize^2, 29]) where M[s, c] = 1 iff sample
    s contributes to cell c (cells: 4 of the 2x2 grid, 9 of 3x3, 16 of 4x4).
    """
    size2 = patsize
    size3 = math.ceil(2.0 * patsize / 3.0)
    size4 = math.ceil(0.5 * patsize)
    winsize = max(3 * size3, 4 * size4)
    n = winsize * winsize
    l = np.zeros(n, np.int32)
    k = np.zeros(n, np.int32)
    M = np.zeros((n, 29), np.float32)
    for s in range(n):
        y = s // winsize
        x = s - winsize * y
        m = max(x, y)
        l[s] = x - size2
        k[s] = y - size2
        if m < 2 * size2:
            x2 = 0 if x < size2 else 1
            y2 = 0 if y < size2 else 1
            M[s, y2 * 2 + x2] = 1.0
        if m < 3 * size3:
            x3 = 0 if x < size3 else (1 if x < 2 * size3 else 2)
            y3 = 0 if y < size3 else (1 if y < 2 * size3 else 2)
            M[s, 4 + y3 * 3 + x3] = 1.0
        if m < 4 * size4:
            x4 = (0 if x < size4 else 1) if x < 2 * size4 else \
                 (2 if x < 3 * size4 else 3)
            y4 = (0 if y < size4 else 1) if y < 2 * size4 else \
                 (2 if y < 3 * size4 else 3)
            M[s, 13 + y4 * 4 + x4] = 1.0
    return l, k, M


@lru_cache(maxsize=None)
def _compare_indices() -> Tuple[np.ndarray, np.ndarray]:
    """The 486 MLDB comparison pairs in emission order (setCompareIndices,
    akazed.cu:65-159).  Entries index the flattened [cell * 3 + channel]
    accumulator layout."""
    i1, i2 = [], []

    def block(cells, chan):
        cl = list(cells)
        for a in range(len(cl)):
            for b in range(a + 1, len(cl)):
                i1.append(3 * cl[a] + chan)
                i2.append(3 * cl[b] + chan)

    for chan in range(3):
        block(range(0, 4), chan)        # 2x2 grid
    for chan in range(3):
        block(range(4, 13), chan)       # 3x3 grid
    for chan in range(3):
        block(range(13, 29), chan)      # 4x4 grid
    assert len(i1) == DESCRIPTOR_BITS
    return np.asarray(i1, np.int32), np.asarray(i2, np.int32)


# --------------------------------------------------------------------------
# nearest-neighbour sampling
# --------------------------------------------------------------------------

# Rows/columns a keypoint's samples can reach from its centre, with margin:
# descriptor |offset| <= scale * 10 * sqrt(2) + 1.5 <= 58.1 for scale 4 (the
# sigma step of the largest sublevel); orientation |offset| <= 5 * scale.
# The row-sharded tier (parallel/spatial.py) exchanges this many halo rows.
SAMPLE_REACH = 64


def make_sampler(layer, flat: FlatPyramid, plan: PipelinePlan,
                 heights=None, row_off=None):
    """Per-keypoint nearest-neighbour reads from its own sublevel plane.

    Returns ``sample(plane, y, x)``: ``plane`` is one of ``flat.L/lx/ly``,
    ``y``/``x`` are [N, K] int32 octave coordinates, and the result is
    [N, K] float32 with 0 for samples outside the octave (the reference's
    bounds-checked reads of ``tmem``, gCalcOrient/gDescribe2).  No matmul
    is involved, so the reads are exact on every backend.

    ``heights``/``row_off`` serve the row-sharded tier: ``heights``
    [noctaves] are the global octave heights for the bounds check, and the
    stored row of global octave row ``y`` is ``y + row_off[octave]``.
    """
    ms = plan.config.max_scale
    o = jnp.maximum(layer // ms, 0)
    s = jnp.maximum(layer, 0) % ms
    base = (flat.offsets[o] + s * flat.plane[o])[:, None]
    wo = flat.widths[o][:, None]
    hs = flat.heights[o][:, None]
    hg = hs if heights is None else heights[o][:, None]
    off = 0 if row_off is None else row_off[o][:, None]

    def sample(plane, y, x):
        inb = (y >= 0) & (y < hg) & (x >= 0) & (x < wo)
        ys = jnp.clip(y + off, 0, hs - 1)
        xs = jnp.clip(x, 0, wo - 1)
        v = plane[base + ys * wo + xs].astype(jnp.float32)
        return jnp.where(inb, v, 0.0)

    return sample


# --------------------------------------------------------------------------
# orientation
# --------------------------------------------------------------------------

def compute_orientation(kps: Keypoints, flat: FlatPyramid,
                        plan: PipelinePlan, fixed: bool = False,
                        heights=None, row_off=None):
    """Dominant orientation per keypoint (gCalcOrient).

    The 11x11 sampling grid (stride = the keypoint's sigma step) is read
    straight from the Lx/Ly planes; the 42-bin histogram and 7-bin circular
    window scan follow akazed.cu:1692-1734.  The histogram is a masked
    reduction (deterministic, unlike the reference's atomicAdd).  Float path
    uses true atan2 for per-sample angles, the fixed kernel the fast
    polynomial (akazed.cu:3685); both use the polynomial for the final
    angle.  ``heights``/``row_off``: see ``make_sampler``.
    """
    sample = make_sampler(kps.layer, flat, plan, heights, row_off)
    o = jnp.maximum(kps.layer // plan.config.max_scale, 0)
    step = (kps.size + 0.5).astype(jnp.int32)
    x = (kps.x + 0.5).astype(jnp.int32) >> o
    y = (kps.y + 0.5).astype(jnp.int32) >> o

    offs = jnp.arange(-5, 6, dtype=jnp.int32)
    dj = jnp.repeat(offs, 11)                           # row offset j
    di = jnp.tile(offs, 11)                             # column offset i
    rows = y[:, None] + step[:, None] * dj[None, :]     # [N, 121]
    cols = x[:, None] + step[:, None] * di[None, :]
    wt = jnp.asarray(_orient_grid()).reshape(-1)        # [121]
    dx = wt * sample(flat.lx, rows, cols)
    dy = wt * sample(flat.ly, rows, cols)
    ang = fast_atan2(dy, dx) if fixed else jnp.arctan2(dy, dx)
    a = jnp.clip((ang * (21.0 / math.pi)).astype(jnp.int32) + 21, 0, 41)

    # 42-bin accumulation (atomicAdd replacement) over the live disc taps
    hit = (a[..., None] == jnp.arange(42)) & (wt > 0)[None, :, None]
    resx = jnp.sum(jnp.where(hit, dx[..., None], 0.0), axis=1)   # [N, 42]
    resy = jnp.sum(jnp.where(hit, dy[..., None], 0.0), axis=1)

    # sliding 7-bin circular window (akazed.cu:1708-1717)
    re8x = sum(jnp.roll(resx, -d, axis=1) for d in range(7))
    re8y = sum(jnp.roll(resy, -d, axis=1) for d in range(7))
    mag = re8x * re8x + re8y * re8y
    maxk = jnp.argmax(mag, axis=1)  # first maximum, matching the strict scan
    bx = jnp.take_along_axis(re8x, maxk[:, None], axis=1)[:, 0]
    by = jnp.take_along_axis(re8y, maxk[:, None], axis=1)[:, 0]
    angle = fast_atan2(by, bx)
    angle = jnp.where(angle < 0.0, angle + 2.0 * math.pi, angle)
    return jnp.where(kps.valid, angle, 0.0)


# --------------------------------------------------------------------------
# MLDB descriptor
# --------------------------------------------------------------------------

class Descriptors(NamedTuple):
    words: jax.Array   # [max_pts, 16] uint32 — 486 bits little-endian


def compute_descriptors(kps: Keypoints, angle, flat: FlatPyramid,
                        plan: PipelinePlan, fixed: bool = False,
                        heights=None, row_off=None) -> Descriptors:
    """MLDB descriptor (gDescribe2): rotated-window cell means of
    (L, rotated Lx, rotated Ly) over 2x2/3x3/4x4 grids, then 486 pairwise
    comparisons packed to bits.

    The 441 rotated nearest-neighbour samples per keypoint are read
    straight from the planes at the reference's absolute positions
    (akazed.cu:1919-1921); the cell sums are one float32 product with the
    static membership table at ``Precision.HIGHEST`` (no TF32 rounding on
    GPUs), and the comparisons gather the 486 cell pairs.  Dead slots get
    all-zero words.  ``heights``/``row_off``: see ``make_sampler``.
    """
    cfg = plan.config
    l_np, k_np, M_np = _descriptor_window(cfg.descriptor_pattern_size)
    lof = jnp.asarray(l_np, jnp.float32)[None, :]
    kof = jnp.asarray(k_np, jnp.float32)[None, :]
    i1, i2 = _compare_indices()

    sample = make_sampler(kps.layer, flat, plan, heights, row_off)
    o = jnp.maximum(kps.layer // cfg.max_scale, 0)
    iratio = 1.0 / (1 << o).astype(jnp.float32)
    scale = (kps.size + 0.5).astype(jnp.int32).astype(jnp.float32)[:, None]
    xf = (kps.x * iratio)[:, None]
    yf = (kps.y * iratio)[:, None]
    co = jnp.cos(angle)[:, None]
    si = jnp.sin(angle)[:, None]

    # rotated sample positions (akazed.cu:1919-1921); int cast truncates
    xp = (xf + scale * (kof * co - lof * si) + 0.5).astype(jnp.int32)
    yp = (yf + scale * (kof * si + lof * co) + 0.5).astype(jnp.int32)
    im = sample(flat.L, yp, xp)                          # [N, 441]
    dx = sample(flat.lx, yp, xp)
    dy = sample(flat.ly, yp, xp)
    rx = -dx * si + dy * co
    ry = dx * co + dy * si
    if fixed:
        # the fixed kernel truncates the rotated derivatives to int
        # (akazed.cu:3779-3780)
        rx = rx.astype(jnp.int32).astype(jnp.float32)
        ry = ry.astype(jnp.int32).astype(jnp.float32)

    v = jnp.stack([im, rx, ry], axis=2)                  # [N, 441, 3]
    acc = jnp.einsum("nsk,sc->nck", v, jnp.asarray(M_np),
                     precision=jax.lax.Precision.HIGHEST
                     ).reshape(v.shape[0], -1)           # [N, 29 * 3]
    bits = (acc[:, i1] > acc[:, i2]) & kps.valid[:, None]
    return Descriptors(words=pack_bits(bits))


def pack_bits(bits):
    """[N, 486] bool -> [N, 16] uint32 little-endian words."""
    n = bits.shape[0]
    pad = jnp.zeros((n, DESCRIPTOR_WORDS * 32 - DESCRIPTOR_BITS), bool)
    bits512 = jnp.concatenate([bits, pad], axis=1)
    b32 = bits512.reshape(-1, DESCRIPTOR_WORDS, 32).astype(jnp.uint32)
    shifts = jnp.arange(32, dtype=jnp.uint32)[None, None, :]
    return jnp.sum(b32 << shifts, axis=2, dtype=jnp.uint32)


def descriptors_to_bytes(words: np.ndarray) -> np.ndarray:
    """Host-side: [N, 16] uint32 -> [N, 61] uint8 (OpenCV-compatible MLDB
    layout, little-endian bit order as in gDescribe2 bit packing)."""
    return np.ascontiguousarray(
        np.asarray(words, dtype="<u4").view(np.uint8).reshape(-1, 64)[:, :61])
