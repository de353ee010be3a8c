"""Keypoint detection: scale-space extrema, NMS, selection, refinement.

Reference kernels: gCalcExtremaMap (akazed.cu:1334-1393), gNmsRNaive
(akazed.cu:1554-1613), gRefine (akazed.cu:1615-1662); fixed-point variants at
akazed.cu:3476-3646.

Design notes:
  * The reference's documented benign data race (non-atomic RMW on the
    full-resolution response/size/layer maps, akazed.cu:1364) becomes a
    deterministic max/argmax over the scale axis followed by a strided
    strictly-greater merge across octaves — same acceptance rule
    (``response_map[oidx] < v``), no race.
  * Atomic keypoint emission (atomicInc, akazed.cu:1603) becomes a masked
    ``nonzero`` into fixed-size SoA tensors with a validity count.  On
    overflow the reference keeps an arbitrary atomic-order subset
    (akaze.cpp:451); we keep the first ``max_pts`` in row-major order,
    which is deterministic.
"""

from __future__ import annotations

from typing import List, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .plan import PipelinePlan
from .scale_space import OctaveData

FMIN_VAL = -1.0e6          # akazed.cu:12
IMIN_VAL = -(1 << 30)      # stand-in for the int map init (akaze.cpp:523)


class Keypoints(NamedTuple):
    """Fixed-capacity SoA keypoint tensors (replaces the AoS AkazePoint
    buffer, akaze_structures.h:19-40)."""
    x: jax.Array         # [max_pts] float32, full-resolution coords
    y: jax.Array         # [max_pts] float32
    size: jax.Array      # [max_pts] float32 (octave-local sigma size)
    layer: jax.Array     # [max_pts] int32: octave * max_scale + scale
    response: jax.Array  # [max_pts] float32
    valid: jax.Array     # [max_pts] bool
    count: jax.Array     # scalar int32
    # scalar bool: True when NMS survivors were dropped (a row overflowed
    # ROW_CAP, or the total exceeded max_pts — the reference clamps the
    # latter silently, akaze.cpp:451; here the loss is signalled)
    overflow: jax.Array = None


def _extrema_candidates(oct_data: OctaveData, oct_plan, threshold, fixed,
                        det_pad=None, row0=0):
    """Per-scale 3x3 strict maxima above threshold inside the border rect.

    Returns (resp [S,H,W] with MIN where not a candidate, per-scale static
    size table).

    ``det_pad``/``row0`` serve the row-sharded tier (parallel/spatial.py):
    a [S, H+2, W] det stack whose extra rows are the neighbours' ghost rows
    (MIN at the global edges), and the shard's global row offset for the
    border-rectangle check.
    """
    det = oct_data.det
    s, h, w = det.shape
    minval = IMIN_VAL if fixed else FMIN_VAL
    if det_pad is None:
        det_pad = jnp.pad(det, ((0, 0), (1, 1), (0, 0)), mode="constant",
                          constant_values=minval)
    pad = jnp.pad(det_pad, ((0, 0), (0, 0), (1, 1)), mode="constant",
                  constant_values=minval)
    c = pad[:, 1:1 + h, 1:1 + w]
    is_max = c > threshold
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            is_max &= c > pad[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]

    rows = jax.lax.broadcasted_iota(jnp.int32, (1, h, w), 1) + row0
    cols = jax.lax.broadcasted_iota(jnp.int32, (1, h, w), 2)
    x_lo = jnp.asarray([sp.x_lo for sp in oct_plan.scales], jnp.int32)
    x_hi = jnp.asarray([sp.x_hi for sp in oct_plan.scales], jnp.int32)
    y_lo = jnp.asarray([sp.y_lo for sp in oct_plan.scales], jnp.int32)
    y_hi = jnp.asarray([sp.y_hi for sp in oct_plan.scales], jnp.int32)
    rect = ((rows >= y_lo[:, None, None]) & (rows <= y_hi[:, None, None])
            & (cols >= x_lo[:, None, None]) & (cols <= x_hi[:, None, None]))
    is_max &= rect
    resp = jnp.where(is_max, c, minval)
    return resp


def build_extrema_maps(octaves: List[OctaveData], plan: PipelinePlan,
                       fixed: bool = False, det_pads=None, row0=0):
    """Full-resolution response/size/layer maps (akaze.cpp:249-258 init +
    gCalcExtremaMap per octave).

    With ``det_pads``/``row0`` (row-sharded tier) the maps cover only this
    shard's rows; ``row0`` is the shard's full-resolution row offset (its
    octave-o offset is ``row0 >> o`` — exact, since the spatial tier keeps
    per-octave local row counts even)."""
    cfg = plan.config
    w0 = plan.width
    h0 = octaves[0].det.shape[1] if det_pads is not None else plan.height
    minval = IMIN_VAL if fixed else FMIN_VAL
    rdtype = jnp.int32 if fixed else jnp.float32
    threshold = cfg.idthreshold if fixed else cfg.dthreshold

    resp_full = jnp.full((h0, w0), minval, rdtype)
    size_full = jnp.zeros((h0, w0), jnp.float32)
    layer_full = jnp.full((h0, w0), -1, jnp.int32)

    for oi, (odata, oplan) in enumerate(zip(octaves, plan.octaves)):
        resp = _extrema_candidates(
            odata, oplan, threshold, fixed,
            det_pad=None if det_pads is None else det_pads[oi],
            row0=row0 >> oi)
        s, h, w = resp.shape
        # deterministic cross-scale winner (replaces the benign race,
        # akazed.cu:1361-1373): argmax picks the lowest scale on ties
        best_s = jnp.argmax(resp, axis=0)
        best = jnp.max(resp, axis=0)
        sizes = jnp.asarray([sp.size for sp in oplan.scales], jnp.float32)
        best_size = sizes[best_s]
        best_layer = oi * cfg.max_scale + best_s.astype(jnp.int32)

        # strided write-back without scatter: expand [h, w] -> [h*r, w*r]
        # with MIN/zero fill at non-multiples (pad + reshape, which XLA
        # lowers to plain copies; .at[::r, ::r].set() lowers to a scatter)
        r = 1 << oi

        def up(x, fill):
            if r == 1:
                return x
            # column then row expansion as stack+reshape (row-major reshape
            # interleaves the fill blocks; no 4D transpose, which lowered to
            # a slow layout shuffle)
            fills = jnp.full_like(x, fill)
            cols = jnp.stack([x] + [fills] * (r - 1), axis=2)
            x = cols.reshape(h, w * r)
            fills_r = jnp.full_like(x, fill)
            rows = jnp.stack([x] + [fills_r] * (r - 1), axis=1)
            x = rows.reshape(h * r, w * r)
            # odd full-res sizes: h*r < h0 by (h0 mod r); the trailing
            # rows/cols can hold no octave-o winner, so pad with fill
            if h * r != h0 or w * r != w0:
                x = jnp.pad(x, ((0, h0 - h * r), (0, w0 - w * r)),
                            constant_values=fill)
            return x

        up_resp = up(best, minval)
        take = up_resp > resp_full  # strictly greater: earlier octaves win
        resp_full = jnp.where(take, up_resp, resp_full)
        size_full = jnp.where(take, up(best_size, 0.0), size_full)
        layer_full = jnp.where(take & (up_resp > threshold),
                               up(best_layer, -1), layer_full)

    return resp_full, size_full, layer_full


def nms(resp_full, size_full, layer_full, plan: PipelinePlan,
        fixed: bool = False, resp_pad=None, row0=0, h_global=None):
    """Circular radius-R NMS (gNmsRNaive, akazed.cu:1554-1613).

    A candidate survives unless a neighbor inside the circle
    i^2 + j^2 < size^2 has strictly larger response, or an equal response in
    the top-left quadrant (i <= 0 and j <= 0) — the reference tie-break
    (akazed.cu:1586-1588).  Returns the survivor mask [H, W].

    Row-sharded tier: ``resp_pad`` is [H + 2*rmax, W] with neighbour ghost
    rows (MIN at global edges), ``row0``/``h_global`` globalize the border
    region check.
    """
    h, w = resp_full.shape
    psz = plan.psz
    rmax = plan.max_nms_radius
    minval = IMIN_VAL if fixed else FMIN_VAL

    fsz = size_full
    # int sqsz = fsz * fsz truncates (akazed.cu:1571)
    sqsz = (fsz * fsz).astype(jnp.int32)
    if resp_pad is None:
        resp_pad = jnp.pad(resp_full, ((rmax, rmax), (0, 0)),
                           mode="constant", constant_values=minval)
    pad = jnp.pad(resp_pad, ((0, 0), (rmax, rmax)), mode="constant",
                  constant_values=minval)

    suppressed = jnp.zeros((h, w), bool)
    for i in range(-rmax, rmax + 1):
        for j in range(-rmax, rmax + 1):
            if i == 0 and j == 0:
                continue
            nresp = pad[rmax + i:rmax + i + h, rmax + j:rmax + j + w]
            in_circle = jnp.int32(i * i + j * j) < sqsz
            beats = (nresp > resp_full)
            if i <= 0 and j <= 0:
                beats |= (nresp == resp_full)
            suppressed |= in_circle & beats

    rows = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0) + row0
    cols = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    hg = h if h_global is None else h_global
    # launch covers ix >= psz with the guard ix + psz < width
    # (akazed.cu:1558-1563)
    region = ((cols >= psz) & (cols + psz < w)
              & (rows >= psz) & (rows + psz < hg))
    return (layer_full >= 0) & region & ~suppressed


ROW_CAP = 32    # max keypoints kept per image row; additionally at most
                # TILE_CAP survive per TILE-column span of a row.  NMS
                # survivors are very sparse — the stock pair averages
                # ~4/row — and any drop is flagged via Keypoints.overflow
                # (the reference clamps silently at max_pts, akaze.cpp:451)
TILE = 64       # column-span width of the two-level compaction.
TILE_CAP = 12   # max survivors kept per row-tile.  The stock pair's FIXED
                # path packs up to 10 survivors into a 128-col span but at
                # most 7 into any 64-col span, so (64, 12) keeps both
                # paths' stock detections lossless (overflow=False) with
                # margin


def _tile_candidates_argmax(mask, h, w, wt, ntiles, TILE_, npick):
    """Level 1 by iterated masked argmax over the full [h, ntiles, TILE]
    key array (~36 passes over H*W elements)."""
    cols = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    key = jnp.where(mask, (w - cols).astype(jnp.float32), 0.0)
    keyt = jnp.pad(key, ((0, 0), (0, wt - w))).reshape(h, ntiles, TILE_)
    lane = jax.lax.broadcasted_iota(jnp.int32, (h, ntiles, TILE_), 2)
    vs, cs = [], []
    tbase = (jnp.arange(ntiles, dtype=jnp.int32) * TILE_)[None, :]
    k = keyt
    for _ in range(npick):
        ar = jnp.argmax(k, axis=2).astype(jnp.int32)    # [h, ntiles]
        vs.append(jnp.max(k, axis=2))
        cs.append(tbase + ar)
        k = jnp.where(lane == ar[:, :, None], 0.0, k)
    cv = jnp.stack(vs, axis=2).reshape(h, -1)     # [h, ntiles*npick]
    cc = jnp.stack(cs, axis=2).reshape(h, -1)
    return cv, cc


_BIT_CHUNK = 16  # columns per packed integer field: sums of 2^0..2^15 stay
                 # exact through a bf16xbf16->f32 matmul (max 65535 < 2^24)


def _tile_candidates_bitpack(mask, h, w, wt, ntiles, TILE_, npick):
    """Level 1 via a bitpack: one matmul per 16-column field packs the
    survivor mask into integer bitfields ([h, ntiles] each), then ``npick``
    lowest-set-bit extractions walk them with elementwise ops over the TINY
    packed arrays.  Replaces ~3*npick passes over all H*W elements with one
    matmul pass + ~25*npick elementwise ops over H*W/TILE elements (whether
    that beats the argmax form on the GPU is not measured yet).  The bf16
    operands are 0/1 and powers of two with float32 accumulation, so the
    packed fields are exact on every backend.  Identical pick semantics to
    the argmax
    form: the npick leftmost survivors of every TILE-column span, in
    ascending column order."""
    nf = TILE_ // _BIT_CHUNK
    maskp = jnp.pad(mask, ((0, 0), (0, wt - w))).astype(jnp.bfloat16)
    fields = []
    for f in range(nf):
        wgt = np.zeros((wt, ntiles), np.float32)
        for t in range(ntiles):
            base = t * TILE_ + f * _BIT_CHUNK
            wgt[base:base + _BIT_CHUNK, t] = 2.0 ** np.arange(_BIT_CHUNK)
        packed = jax.lax.dot(maskp, jnp.asarray(wgt, jnp.bfloat16),
                             preferred_element_type=jnp.float32)
        fields.append(packed.astype(jnp.int32))
    vs, cs = [], []
    tbase = (jnp.arange(ntiles, dtype=jnp.int32) * TILE_)[None, :]
    for _ in range(npick):
        nz = [fld != 0 for fld in fields]
        val = fields[nf - 1]
        cidx = jnp.full((h, ntiles), nf - 1, jnp.int32)
        for k in range(nf - 2, -1, -1):
            val = jnp.where(nz[k], fields[k], val)
            cidx = jnp.where(nz[k], k, cidx)
        anyset = val != 0
        b = val & -val
        bitidx = jax.lax.population_count(b - 1)
        col = tbase + cidx * _BIT_CHUNK + bitidx
        vs.append(jnp.where(anyset, (w - col).astype(jnp.float32), 0.0))
        cs.append(col)
        # clear the extracted bit in the first nonzero field only
        prev = jnp.zeros((h, ntiles), bool)
        for k in range(nf):
            first = nz[k] & ~prev
            fields[k] = jnp.where(first, fields[k] & (fields[k] - 1),
                                  fields[k])
            prev = prev | nz[k]
    cv = jnp.stack(vs, axis=2).reshape(h, -1)     # [h, ntiles*npick]
    cc = jnp.stack(cs, axis=2).reshape(h, -1)
    return cv, cc


def select_keypoints(mask, resp_full, size_full, layer_full,
                     max_pts: int, row_cap: int = None,
                     tile_cap: int = None, tile: int = None,
                     size_table: tuple = None) -> Keypoints:
    """Masked compaction into fixed-size SoA tensors.

    A flat ``jnp.nonzero`` over the full-resolution mask costs a cumsum +
    scatter over H*W elements, and a per-row ``lax.top_k`` over the full
    width a partial sort of W elements per row.  Survivors are sparse, so
    compact in three levels:
    per-TILE-column-span top-TILE_CAP leftmost survivors (bitpack +
    lowest-set-bit walks; see _tile_candidates_bitpack), per-row top-ROW_CAP
    over the few tile candidates, then one small nonzero over the
    [H*ROW_CAP] list.  Exact row-major order: the key encodes descending
    column rank, tiles partition columns in order, and ties cannot occur
    among live keys.
    """
    ROW_CAP_ = ROW_CAP if row_cap is None else row_cap
    TILE_CAP_ = TILE_CAP if tile_cap is None else tile_cap
    TILE_ = TILE if tile is None else tile
    h, w = mask.shape
    wt = -(-w // TILE_) * TILE_
    ntiles = wt // TILE_
    cap = min(ROW_CAP_, w, ntiles * TILE_CAP_)
    count = jnp.minimum(jnp.sum(mask.astype(jnp.int32)), max_pts)
    npick = min(TILE_CAP_, cap)
    lvl1 = (_tile_candidates_bitpack if TILE_ % _BIT_CHUNK == 0
            else _tile_candidates_argmax)
    cv, cc = lvl1(mask, h, w, wt, ntiles, TILE_, npick)

    # level 2: top-ROW_CAP per row over the tile candidates (tiles
    # partition columns in order, so key order == global column order)
    topv, sel = jax.lax.top_k(cv, cap)            # [h, cap]
    topi = jnp.take_along_axis(cc, sel, axis=1)
    cvalid = topv > 0.0
    # flatten candidates; row-major order preserved (rows ascending, columns
    # ascending within a row)
    flat_idx = (jax.lax.broadcasted_iota(jnp.int32, (h, cap), 0) * w
                + topi).reshape(-1)
    cflat = cvalid.reshape(-1)
    # compaction via ONE 2-operand sort (valid candidates first, original
    # order preserved) over the small [h*cap] candidate list
    pos = jnp.arange(h * cap, dtype=jnp.int32)
    skey = jnp.where(cflat, pos, jnp.int32(np.iinfo(np.int32).max))
    _, sidx = jax.lax.sort((skey, flat_idx), num_keys=1)
    n_cand = jnp.sum(cflat.astype(jnp.int32))
    got = jnp.arange(max_pts, dtype=jnp.int32) < n_cand
    if max_pts <= h * cap:
        sidx = sidx[:max_pts]
    else:
        sidx = jnp.pad(sidx, (0, max_pts - h * cap))
    idx = jnp.where(got, sidx, 0).astype(jnp.int32)
    # a row overflowing ROW_CAP drops its tail; count reflects what was
    # kept and the loss is flagged
    total = jnp.sum(mask.astype(jnp.int32))
    overflow = (total > n_cand) | (total > max_pts)
    count = jnp.minimum(count, n_cand)
    valid = jnp.arange(max_pts, dtype=jnp.int32) < count
    y = idx // w
    x = idx % w
    layer = layer_full.ravel()[idx]
    if size_table is not None:
        # sizes are a static per-sublevel table (build_extrema_maps wrote
        # size_full = sizes[winning scale]), so derive size from the layer
        # code with a fused where-chain instead of a third full-resolution
        # gather; live slots always have layer >= 0
        size = jnp.full(x.shape, 0.0, jnp.float32)
        for li, sz in enumerate(size_table):
            size = jnp.where(layer == li, jnp.float32(sz), size)
    else:
        size = size_full.ravel()[idx]
    return Keypoints(
        x=x.astype(jnp.float32), y=y.astype(jnp.float32),
        size=size,
        layer=layer,
        response=resp_full.ravel()[idx].astype(jnp.float32),
        valid=valid, count=count, overflow=overflow)


class FlatPyramid(NamedTuple):
    """All octave planes concatenated flat for per-keypoint gathers.

    The analogue of the reference's single ``tmem`` scratch buffer with the
    ``d_oparams`` offset table (akazed.cu:23, 59): one gather serves all
    keypoints regardless of their octave.
    """
    L: jax.Array      # [total]
    det: jax.Array
    lx: jax.Array
    ly: jax.Array
    offsets: jax.Array  # [noctaves] int32: start of each octave's stack
    widths: jax.Array   # [noctaves] int32
    heights: jax.Array  # [noctaves] int32
    plane: jax.Array    # [noctaves] int32: H_o * W_o


def flatten_pyramid(octaves: List[OctaveData],
                    det_only: bool = False) -> FlatPyramid:
    offs, widths, heights, planes = [], [], [], []
    total = 0
    for o in octaves:
        s, h, w = o.det.shape
        offs.append(total)
        widths.append(w)
        heights.append(h)
        planes.append(h * w)
        total += s * h * w
    det = jnp.concatenate([o.det.ravel() for o in octaves])
    if det_only:
        # refinement only reads the det plane; concatenating the other
        # three copies the whole pyramid for nothing
        L = lx = ly = det
    else:
        L = jnp.concatenate([o.L.ravel() for o in octaves])
        lx = jnp.concatenate([o.lx.ravel() for o in octaves])
        ly = jnp.concatenate([o.ly.ravel() for o in octaves])
    return FlatPyramid(
        L=L, det=det, lx=lx, ly=ly,
        offsets=jnp.asarray(offs, jnp.int32),
        widths=jnp.asarray(widths, jnp.int32),
        heights=jnp.asarray(heights, jnp.int32),
        plane=jnp.asarray(planes, jnp.int32))


def refine_keypoints(kps: Keypoints, flat: FlatPyramid, plan: PipelinePlan,
                     fixed: bool = False, row_shift=None,
                     buckets: bool = False) -> Keypoints:
    """Sub-pixel refinement (gRefine, akazed.cu:1615-1662): 3x3 quadratic
    fit on the det plane; offsets outside (-1, 1) keep the integer
    location.

    Row-sharded tier: ``row_shift`` ([noctaves] int32) maps a keypoint's
    global octave row to its row in this shard's halo-extended det stack
    (shard offset minus the one-row halo).  Seam-exact because the extrema
    border rect keeps every keypoint >= 1 row inside the global image at
    its own octave, so the 3x3 fit never reads the constant-fill rows.

    ``buckets``: run the stencil gathers inside a ``lax.switch`` over
    capacity buckets so dead slots past the smallest bucket >= count are
    never fetched.  Bit-exact (dead slots keep x/y either way).  Leave off
    under vmap (all switch branches would execute, data_parallel.py:51)."""
    if buckets:
        caps = [c for c in (1024, 2048, 4096) if c < kps.x.shape[0]]
        caps.append(kps.x.shape[0])

        def make_branch(nb):
            def br(kps):
                sub = kps._replace(
                    x=kps.x[:nb], y=kps.y[:nb], layer=kps.layer[:nb],
                    valid=kps.valid[:nb])
                ref = refine_keypoints(sub, flat, plan, fixed, row_shift)
                return (jnp.concatenate([ref.x, kps.x[nb:]]),
                        jnp.concatenate([ref.y, kps.y[nb:]]))
            return br

        bi = sum((kps.count > c).astype(jnp.int32) for c in caps[:-1])
        nx, ny = jax.lax.switch(bi, [make_branch(c) for c in caps], kps)
        return kps._replace(x=nx, y=ny)

    ms = plan.config.max_scale
    o = kps.layer // ms
    s = kps.layer % ms
    o = jnp.maximum(o, 0)  # guard invalid slots (layer == -1)
    wo = flat.widths[o]
    base = flat.offsets[o] + s * flat.plane[o]
    xo = kps.x.astype(jnp.int32) >> o
    yo = kps.y.astype(jnp.int32) >> o
    # the gather index uses shard-local rows; the refined coordinate below
    # stays in global rows (yo)
    yo_idx = yo if row_shift is None else yo - row_shift[o]
    idx = base + yo_idx * wo + xo

    det = flat.det

    # one gather per stencil ROW instead of nine scalar gathers: fetch
    # three [N, 3] contiguous row segments (dynamic_slice clamps
    # out-of-range starts, matching the clamped scalar gathers this
    # replaces)
    def row3(start):
        return jax.vmap(
            lambda s: jax.lax.dynamic_slice(det, (s,), (3,)))(start)

    top = row3(idx - wo - 1)    # [g(-wo-1), g(-wo), g(-wo+1)]
    mid = row3(idx - 1)         # [g(-1),    g(0),   g(1)]
    bot = row3(idx + wo - 1)    # [g(wo-1),  g(wo),  g(wo+1)]

    c = mid[:, 1]
    if fixed:
        # int arithmetic with arithmetic shifts (akazed.cu:3621-3627);
        # int32 overflow wraps exactly as CUDA's int does
        v2 = c + c
        dx = (mid[:, 2] - mid[:, 0]) >> 1
        dy = (bot[:, 1] - top[:, 1]) >> 1
        dxx = mid[:, 2] + mid[:, 0] - v2
        dyy = bot[:, 1] + top[:, 1] - v2
        dxy = (bot[:, 2] + top[:, 0] - top[:, 2] - bot[:, 0]) >> 2
        dd = dxx * dyy - dxy * dxy
        dxf, dyf = dx.astype(jnp.float32), dy.astype(jnp.float32)
        dxxf, dyyf = dxx.astype(jnp.float32), dyy.astype(jnp.float32)
        dxyf = dxy.astype(jnp.float32)
        idd = jnp.where(dd != 0, 1.0 / dd.astype(jnp.float32), 0.0)
    else:
        v2 = c + c
        dxf = 0.5 * (mid[:, 2] - mid[:, 0])
        dyf = 0.5 * (bot[:, 1] - top[:, 1])
        dxxf = mid[:, 2] + mid[:, 0] - v2
        dyyf = bot[:, 1] + top[:, 1] - v2
        dxyf = 0.25 * (bot[:, 2] + top[:, 0] - top[:, 2] - bot[:, 0])
        dd = dxxf * dyyf - dxyf * dxyf
        idd = jnp.where(dd != 0.0, 1.0 / dd, 0.0)

    dst0 = idd * (dxyf * dyf - dyyf * dxf)
    dst1 = idd * (dxyf * dxf - dxxf * dyf)
    weak = (dst0 < -1.0) | (dst0 > 1.0) | (dst1 < -1.0) | (dst1 > 1.0)
    ratio = (1 << o).astype(jnp.float32)
    new_x = ratio * (xo.astype(jnp.float32) + dst0)
    new_y = ratio * (yo.astype(jnp.float32) + dst1)
    keep = weak | ~kps.valid
    return kps._replace(x=jnp.where(keep, kps.x, new_x),
                        y=jnp.where(keep, kps.y, new_y))


def size_table_for(plan: PipelinePlan) -> tuple:
    """Static per-layer-code sigma-size table (what build_extrema_maps
    writes into size_full), for the gather-free size reconstruction in
    select_keypoints."""
    ms = plan.config.max_scale
    table = [0.0] * (len(plan.octaves) * ms)
    for oi, oplan in enumerate(plan.octaves):
        for si, sp in enumerate(oplan.scales):
            table[oi * ms + si] = float(sp.size)
    return tuple(table)


def detect_keypoints(octaves: List[OctaveData], plan: PipelinePlan,
                     fixed: bool = False, buckets: bool = False) -> Keypoints:
    """Full detection stage: extrema maps -> NMS -> selection -> refine.

    ``buckets``: count-bucketed refinement gathers (see refine_keypoints);
    only safe outside vmap."""
    resp, size, layer = build_extrema_maps(octaves, plan, fixed)
    mask = nms(resp, size, layer, plan, fixed)
    kps = select_keypoints(mask, resp, size, layer, plan.config.max_pts,
                           size_table=size_table_for(plan))
    flat = flatten_pyramid(octaves, det_only=True)
    return refine_keypoints(kps, flat, plan, fixed, buckets=buckets)
