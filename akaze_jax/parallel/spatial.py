"""Spatially (row-) sharded scale-space construction with halo exchange.

The reference handles image scale only through the octave pyramid with its
<80 px early stop (akaze.cpp:211-223); one GPU must hold every plane.  This
module is the long-axis answer for images too large for one card's memory
(SURVEY.md "long-context" analog): the image is sharded by ROWS across a 1D
mesh axis and the whole nonlinear scale space is built under ``shard_map``,
with each stencil's ghost rows exchanged between neighbouring cards
(NVLink) via ``lax.ppermute`` (neighbour-only traffic — no all-gathers of
image planes).

Exactness.  Every stencil in the pipeline (separable Gaussians ops/conv.py,
Scharr windows ops/scharr.py, the FED step ops/diffusion.py) uses
reflect-101 borders via ``jnp.pad(mode="reflect")``.  Extending a local
block with ``r`` genuine neighbour rows (reflect-101 of the *local* block at
the global edges) and cropping ``r`` output rows reproduces the unsharded
op value-for-value — BIT-exact on the 16.16 fixed path (integer arithmetic;
asserted in tests/test_spatial.py), and to ulp-level FMA-contraction noise
(measured <= 2e-7) on the float path, where XLA fuses the identical
expressions differently inside the shard_map program:

* interior devices see genuine data for the whole stencil footprint;
* edge devices see exactly the rows ``mode="reflect"`` would synthesize.

Two consequences shape the code:

* ``hessian_determinant`` reflect-pads the *derivative fields themselves*
  (gHessianDeterminant reads Lx/Ly with borderAdd, akazed.cu:1299-1331), and
  Ly is antisymmetric under row reflection — so derivatives and the Hessian
  must be exchanged in two separate rounds (fusing them into one wider
  exchange would silently flip Ly's sign inside the global border band).
* the FED inner loop needs only ONE exchange of ``len(taus)`` rows for the
  whole cycle: ``nld_step`` commutes with row reflection, so ghost rows stay
  valid by symmetry at the global edges and shrink by one row per step
  everywhere else — exactly the budget the final crop removes.

The per-octave decimation keeps whole even row pairs on each device
(``spatial_supported`` checks divisibility), so ``down_with_smooth``'s
source-grid taps at +-2/+-4 stay aligned after cropping 2 dest rows.

The contrast percentile is the only global quantity: its max and the 9
bisection counts are ``psum``/``pmax`` scalars (ops/contrast.py semantics
preserved; the threshold uses the GLOBAL pixel count).

``spatial_detect_and_compute`` extends the tier through the whole
front-end: extrema/NMS see neighbour ghost rows (MIN-filled at the global
edges, exactly the unsharded constant pads), refinement reads the shard's
halo-1 det stack with globalized coordinates, and orientation/descriptor
samples are read from SAMPLE_REACH-halo-extended plane stacks so
seam-straddling keypoints sample genuine neighbour rows.  Only the keypoint SoA is
all-gathered (tiled, in mesh order == global row-major order) and
compacted to the valid prefix the matcher expects.
"""

from __future__ import annotations

import math
from functools import partial
from typing import List, Tuple

import jax
import jax.numpy as jnp
from jax import lax, shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..ops import (conductivity, conductivity_fixed, down_with_smooth,
                   down_with_smooth_fixed, hessian_determinant,
                   hessian_determinant_fixed, lowpass, lowpass_fixed,
                   scaled_derivatives, scaled_derivatives_fixed,
                   scharr_magnitude, scharr_magnitude_fixed)
from ..ops.contrast import NBINS
from ..ops.conv import radius_for_ksize
from ..plan import PipelinePlan
from ..scale_space import OctaveData, _diffuse
from ..detect import (FMIN_VAL, IMIN_VAL, Keypoints, build_extrema_maps,
                      flatten_pyramid, nms, refine_keypoints,
                      select_keypoints, size_table_for)
from ..descriptor import (SAMPLE_REACH, compute_descriptors,
                          compute_orientation)


def _extend_rows_of(x, r: int, axis_name: str, n_dev: int, row_axis: int,
                    edge="reflect"):
    """Extend ``row_axis`` of x by r ghost rows each side.

    Interior seams receive genuine neighbour rows via ppermute; the global
    top/bottom get reflect-101 of the local block (``edge="reflect"``) or a
    constant fill (``edge=<value>`` — detection maps pad with MIN, the
    descriptor planes with 0, matching the unsharded constant pads).
    """
    if r == 0:
        return x
    h = x.shape[row_axis]

    def rows(a, b):
        return lax.slice_in_dim(x, a, b, axis=row_axis)

    if edge == "reflect":
        top_edge = jnp.flip(rows(1, r + 1), axis=row_axis)       # rows r..1
        bot_edge = jnp.flip(rows(h - r - 1, h - 1), axis=row_axis)
    else:
        shape = list(x.shape)
        shape[row_axis] = r
        top_edge = bot_edge = jnp.full(shape, edge, x.dtype)
    if n_dev == 1:
        return jnp.concatenate([top_edge, x, bot_edge], axis=row_axis)
    # my top ghost rows = previous device's bottom rows (shift down the ring)
    top_src = lax.ppermute(rows(h - r, h), axis_name,
                           [(i, i + 1) for i in range(n_dev - 1)])
    bot_src = lax.ppermute(rows(0, r), axis_name,
                           [(i + 1, i) for i in range(n_dev - 1)])
    idx = lax.axis_index(axis_name)
    top = jnp.where(idx == 0, top_edge, top_src)
    bot = jnp.where(idx == n_dev - 1, bot_edge, bot_src)
    return jnp.concatenate([top, x, bot], axis=row_axis)


def _extend_rows(x, r: int, axis_name: str, n_dev: int):
    """[h, W] local block -> [h + 2r, W] with reflect-101 global edges."""
    return _extend_rows_of(x, r, axis_name, n_dev, 0, "reflect")


def _stencil(op, x, r: int, axis_name: str, n_dev: int):
    """Apply a same-shape row-stencil of radius ``r`` across shard seams."""
    if r == 0:
        return op(x)
    ext = _extend_rows(x, r, axis_name, n_dev)
    return op(ext)[r:-r]


def _percentile_bisect_global(bins, npix: int, per: float, axis_name: str):
    """ops/contrast.py:_percentile_bisect with psum'd counts (the reference's
    host percentile loop over the *global* histogram, akazed.cu:2468-2481)."""
    hist0 = lax.psum(jnp.sum(bins == 0, dtype=jnp.int32), axis_name)
    thresh = ((npix - hist0).astype(jnp.float32) * per).astype(jnp.int32)

    def cprime(m):
        return lax.psum(jnp.sum(bins <= m, dtype=jnp.int32),
                        axis_name) - hist0

    def body(_, lohi):
        lo, hi = lohi
        mid = (lo + hi) // 2
        ge = cprime(mid) >= thresh
        return jnp.where(ge, lo, mid + 1), jnp.where(ge, mid, hi)

    lo, _ = lax.fori_loop(0, 9, body, (jnp.int32(0), jnp.int32(NBINS - 1)))
    return jnp.minimum(lo + 1, NBINS).astype(jnp.int32)


def _percentile_contrast_global(grad, per: float, npix: int, axis_name: str,
                                fixed: bool):
    """Global-image percentile contrast from a row shard of magnitudes."""
    if fixed:
        max_contrast = jnp.maximum(
            jnp.int32(1), lax.pmax(jnp.max(grad), axis_name))
        hfactor = (NBINS / max_contrast.astype(jnp.float32) * 65536
                   + 0.5).astype(jnp.int32)
        bins = jnp.clip((grad * hfactor) >> 16, 0, NBINS - 1)
        k = _percentile_bisect_global(bins, npix, per, axis_name)
        return k * max_contrast // NBINS
    max_contrast = jnp.maximum(jnp.float32(0.03),
                               lax.pmax(jnp.max(grad), axis_name))
    hfactor = NBINS / max_contrast
    bins = jnp.clip((grad * hfactor).astype(jnp.int32), 0, NBINS - 1)
    k = _percentile_bisect_global(bins, npix, per, axis_name)
    return k.astype(jnp.float32) / hfactor


def _octave_radii(plan: PipelinePlan, oi: int) -> List[int]:
    """Every row-halo radius the build needs at octave ``oi``."""
    cfg = plan.config
    radii = []
    if oi == 0:
        ksz = 2 * math.ceil((cfg.soffset - 0.8) / 0.3) + 3
        radii += [2, 1, radius_for_ksize(ksz)]     # pre-smooth, Scharr, base
    else:
        radii.append(4)                            # down_with_smooth taps
    for sp in plan.octaves[oi].scales:
        radii += [2, 1, len(sp.taus), sp.sigma_size]
    return radii


def spatial_supported(plan: PipelinePlan, n_dev: int, detect: bool = False,
                      describe: bool = False) -> Tuple[bool, str]:
    """Whether every octave keeps whole, large-enough row blocks per device.

    Each halo of radius r needs r rows from ONE neighbour (and reflect-101
    needs r <= h_local - 1); decimation needs the local row count even so
    each device keeps whole source row pairs.  ``detect`` adds the NMS
    radius (full-resolution rows).  ``describe`` adds no constraint: deep
    octaves too thin for the SAMPLE_REACH halo are all-gathered whole
    (tiny planes, see _ext_desc_stack), so any detect-supported layout can
    also describe.
    """
    for oi, op in enumerate(plan.octaves):
        if op.height % n_dev:
            return False, (f"octave {oi} height {op.height} not divisible "
                           f"by {n_dev} devices")
        h_loc = op.height // n_dev
        if oi + 1 < len(plan.octaves) and h_loc % 2:
            return False, (f"octave {oi} local rows {h_loc} odd — cannot "
                           "decimate whole row pairs per device")
        radii = _octave_radii(plan, oi)
        if detect:
            radii.append(1)                      # extrema / refine halos
            if oi == 0:
                radii.append(plan.max_nms_radius)
        r = max(radii)
        if r > h_loc - 1:
            return False, (f"octave {oi} needs halo {r} > local rows "
                           f"{h_loc} - 1; use fewer devices or a larger "
                           "image")
    return True, ""


def _build_local(image, plan: PipelinePlan, axis_name: str, n_dev: int,
                 fixed: bool):
    """scale_space.build_scale_space on one row shard, with per-op halo
    exchanges."""
    cfg = plan.config
    soffset = cfg.soffset
    npix = plan.height * plan.width

    lowpass_fn = lowpass_fixed if fixed else lowpass
    conduct_fn = conductivity_fixed if fixed else conductivity
    deriv_fn = scaled_derivatives_fixed if fixed else scaled_derivatives
    hess_fn = hessian_determinant_fixed if fixed else hessian_determinant
    down_fn = down_with_smooth_fixed if fixed else down_with_smooth
    mag_fn = scharr_magnitude_fixed if fixed else scharr_magnitude

    def S(op, x, r):
        return _stencil(op, x, r, axis_name, n_dev)

    octaves = []
    kcontrast = None
    prev_L_last = None
    for oi, oct_plan in enumerate(plan.octaves):
        Ls, dets, lxs, lys = [], [], [], []
        L_prev = None
        for sp in oct_plan.scales:
            if oi == 0 and sp.scale == 0:
                pre = S(lambda a: lowpass_fn(a, 1.0, 5), image, 2)
                mag = S(mag_fn, pre, 1)
                kcontrast = _percentile_contrast_global(
                    mag, cfg.per, npix, axis_name, fixed)
                var = soffset * soffset
                ksz = 2 * math.ceil((soffset - 0.8) / 0.3) + 3
                L = S(lambda a: lowpass_fn(a, var, ksz), image,
                      radius_for_ksize(ksz))
                smooth = L
            elif sp.scale == 0:
                if fixed:
                    kcontrast = (kcontrast.astype(jnp.float32) * 0.75
                                 + 0.5).astype(jnp.int32)
                else:
                    kcontrast = kcontrast * jnp.float32(0.75)
                # crop 2 dest rows <-> the 4 ghost source rows each side
                ext = _extend_rows(prev_L_last, 4, axis_name, n_dev)
                dst_e, smooth_e = down_fn(ext)
                dst, smooth = dst_e[2:-2], smooth_e[2:-2]
                flow = S(lambda s: conduct_fn(s, cfg.diffusivity,
                                              kcontrast), smooth, 1)
                T = len(sp.taus)
                L = _diffuse(_extend_rows(dst, T, axis_name, n_dev),
                             _extend_rows(flow, T, axis_name, n_dev),
                             sp.taus, fixed)
                L = L[T:-T] if T else L
            else:
                smooth = S(lambda a: lowpass_fn(a, 1.0, 5), L_prev, 2)
                flow = S(lambda s: conduct_fn(s, cfg.diffusivity,
                                              kcontrast), smooth, 1)
                T = len(sp.taus)
                L = _diffuse(_extend_rows(L_prev, T, axis_name, n_dev),
                             _extend_rows(flow, T, axis_name, n_dev),
                             sp.taus, fixed)
                L = L[T:-T] if T else L

            ss = sp.sigma_size
            lxe, lye = deriv_fn(
                _extend_rows(smooth, ss, axis_name, n_dev), ss)
            lx, ly = lxe[ss:-ss], lye[ss:-ss]
            # two separate exchanges (module docstring: Ly antisymmetry)
            det = hess_fn(_extend_rows(lx, ss, axis_name, n_dev),
                          _extend_rows(ly, ss, axis_name, n_dev),
                          ss)[ss:-ss]
            Ls.append(L)
            dets.append(det)
            lxs.append(lx)
            lys.append(ly)
            L_prev = L

        prev_L_last = L_prev
        octaves.append(OctaveData(L=jnp.stack(Ls), det=jnp.stack(dets),
                                  lx=jnp.stack(lxs), ly=jnp.stack(lys)))
    return tuple(octaves), kcontrast


def spatial_scale_space(image, plan: PipelinePlan, mesh: Mesh,
                        axis: str = "data", fixed: bool = False):
    """Build the scale space with image rows sharded over ``mesh[axis]``.

    Args:
      image: [H, W] global image (sharded or replicated; shard_map reshards).
      plan: static plan for (H, W).
      mesh: 1D (or larger) mesh; rows shard over ``axis``.
      fixed: 16.16 fixed-point flavour.

    Returns:
      (octaves, kcontrast) exactly as ``build_scale_space`` — each plane
      row-sharded over ``axis`` (axis 1 of the [S, H, W] stacks).

    Raises:
      ValueError if the (plan, device-count) pair leaves some octave with
      blocks too thin for its halos (``spatial_supported``).
    """
    n_dev = mesh.shape[axis]
    ok, why = spatial_supported(plan, n_dev)
    if not ok:
        raise ValueError(f"spatial sharding unsupported: {why}")

    plane = P(None, axis, None)
    out_specs = (tuple(OctaveData(plane, plane, plane, plane)
                       for _ in plan.octaves), P())

    go = shard_map(
        partial(_build_local, plan=plan, axis_name=axis, n_dev=n_dev,
                fixed=fixed),
        mesh=mesh, in_specs=P(axis, None), out_specs=out_specs,
        check_vma=False)
    return go(image)


# --------------------------------------------------------------------------
# row-sharded detection + description
# --------------------------------------------------------------------------

def _desc_octave_gathered(octaves):
    """Per-octave: True when the SAMPLE_REACH halo exceeds the local rows
    and the (small) octave planes are all-gathered whole instead."""
    return [o.L.shape[1] - 1 < SAMPLE_REACH for o in octaves]


def _ext_desc_pyramid(octaves, row0, axis_name: str, n_dev: int, fill):
    """Halo-extended plane stacks for orientation/descriptor sampling.

    Each octave's L/Lx/Ly get SAMPLE_REACH ghost rows per side (``fill``
    at the global edges, where the sampler's bounds check reads 0 anyway),
    so seam-straddling keypoints read genuine neighbour rows.  Deep octaves
    whose local row count cannot cover the halo are all-gathered WHOLE
    instead (tiled over rows): their planes are tiny — at 960x1280 over 4
    devices the first gathered octave is 240x320.

    Returns (flat pyramid, row_off [noctaves]) with stored row = global
    octave row + row_off, as ``descriptor.make_sampler`` takes them.
    """
    hd = SAMPLE_REACH
    gathered = _desc_octave_gathered(octaves)
    ext, row_off = [], []
    for oi, (o, g) in enumerate(zip(octaves, gathered)):
        def prep(x):
            if g and n_dev > 1:
                x = lax.all_gather(x, axis_name, axis=1, tiled=True)
            return _extend_rows_of(x, hd, axis_name, 1 if g else n_dev, 1,
                                   edge=fill)

        eL = prep(o.L)
        ext.append(OctaveData(L=eL, det=eL, lx=prep(o.lx), ly=prep(o.ly)))
        # ext row e <-> global octave row (shard row0 - hd) + e; gathered
        # octaves hold the WHOLE plane, so their shard offset is 0
        row_off.append(jnp.int32(hd) - (0 if g else row0 >> oi))
    return flatten_pyramid(ext), jnp.stack(row_off)


def _gather_features(kps: Keypoints, angle, words, axis_name: str,
                     max_pts: int):
    """All-gather per-shard features and compact to the global row-major
    prefix (shards hold contiguous row bands in mesh order, so the tiled
    gather concatenates in exactly the unsharded emission order)."""
    from ..pipeline import Features

    fields = (kps.x, kps.y, kps.size, kps.layer, kps.response, angle, words)
    gath = [lax.all_gather(f, axis_name, axis=0, tiled=True)
            for f in fields]
    valid_g = lax.all_gather(kps.valid, axis_name, axis=0, tiled=True)
    total = jnp.sum(valid_g.astype(jnp.int32))
    (sel,) = jnp.nonzero(valid_g, size=max_pts, fill_value=0)
    count = jnp.minimum(total, max_pts)
    got = jnp.arange(max_pts, dtype=jnp.int32) < count

    def take(a):
        t = a[sel]
        m = got if t.ndim == 1 else got[:, None]
        return jnp.where(m, t, jnp.zeros_like(t))

    x, y, size, layer, resp, ang, wrd = (take(a) for a in gath)
    overflow = (jnp.any(lax.all_gather(kps.overflow, axis_name))
                | (total > max_pts))
    return Features(x=x, y=y, size=size, layer=layer, response=resp,
                    angle=ang, words=wrd, valid=got, count=count,
                    overflow=overflow)


def _detect_describe_local(image, plan: PipelinePlan, axis_name: str,
                           n_dev: int, fixed: bool, describe: bool):
    """Full front-end on one row shard; returns globally-compacted
    (replicated) Features."""
    cfg = plan.config
    octaves, _ = _build_local(image, plan, axis_name, n_dev, fixed)
    d = lax.axis_index(axis_name)
    row0 = d.astype(jnp.int32) * (plan.height // n_dev)
    minval = IMIN_VAL if fixed else FMIN_VAL

    # detection maps: extrema (halo 1, MIN-filled global edges exactly like
    # the unsharded constant pad), NMS (halo rmax), then local selection
    det_pads = [_extend_rows_of(o.det, 1, axis_name, n_dev, 1, edge=minval)
                for o in octaves]
    resp, size, layer = build_extrema_maps(octaves, plan, fixed,
                                           det_pads=det_pads, row0=row0)
    resp_pad = _extend_rows_of(resp, plan.max_nms_radius, axis_name, n_dev,
                               0, edge=minval)
    mask = nms(resp, size, layer, plan, fixed, resp_pad=resp_pad,
               row0=row0, h_global=plan.height)
    kps = select_keypoints(mask, resp, size, layer, cfg.max_pts,
                           size_table=size_table_for(plan))
    kps = kps._replace(y=kps.y + row0.astype(jnp.float32))

    # refinement on the same halo-1 det stacks (seam-exact: the extrema
    # border rect keeps every keypoint >= 1 row inside the global image)
    fake = [OctaveData(L=dp, det=dp, lx=dp, ly=dp) for dp in det_pads]
    flat = flatten_pyramid(fake, det_only=True)
    shift = jnp.stack([(row0 >> oi) - 1
                       for oi in range(len(plan.octaves))])
    kps = refine_keypoints(kps, flat, plan, fixed, row_shift=shift)

    if describe:
        flat, row_off = _ext_desc_pyramid(octaves, row0, axis_name, n_dev,
                                          0 if fixed else 0.0)
        heights = jnp.asarray([op.height for op in plan.octaves], jnp.int32)
        angle = compute_orientation(kps, flat, plan, fixed, heights, row_off)
        words = compute_descriptors(kps, angle, flat, plan, fixed, heights,
                                    row_off).words
    else:
        angle = jnp.zeros_like(kps.x)
        words = jnp.zeros((cfg.max_pts, 16), jnp.uint32)
    return _gather_features(kps, angle, words, axis_name, cfg.max_pts)


def spatial_detect_and_compute(image, plan: PipelinePlan, mesh: Mesh,
                               axis: str = "data", fixed: bool = False,
                               describe: bool = True):
    """detect_and_compute with image rows sharded over ``mesh[axis]``.

    The whole front-end — scale space, extrema, NMS, selection, sub-pixel
    refinement, orientation, MLDB descriptors — runs on row shards with
    neighbour-only halo traffic; only the (small) keypoint SoA is
    all-gathered at the end.  Together with ``sharded_match`` this serves
    images whose planes exceed one card's memory (the reference's only
    size lever is the <80 px octave early stop, akaze.cpp:211-223).

    Returns replicated ``Features`` matching the unsharded XLA path (same
    keypoints in the same row-major order; descriptor bits equal up to the
    FMA-contraction noise any re-fused XLA program exhibits).
    """
    n_dev = mesh.shape[axis]
    ok, why = spatial_supported(plan, n_dev, detect=True, describe=describe)
    if not ok:
        raise ValueError(f"spatial sharding unsupported: {why}")
    from ..pipeline import Features

    go = shard_map(
        partial(_detect_describe_local, plan=plan, axis_name=axis,
                n_dev=n_dev, fixed=fixed, describe=describe),
        mesh=mesh, in_specs=P(axis, None),
        out_specs=Features(*([P()] * 10)), check_vma=False)
    return go(image)
