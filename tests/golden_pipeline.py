"""Composed numpy golden model of the FULL detect+describe pipeline.

Extends the per-kernel oracles of golden.py into one end-to-end reference
(scale space -> extrema -> NMS -> selection -> refine -> orientation ->
MLDB descriptor) mirroring the reference host flow (akaze.cpp:240-503) and
kernels directly in numpy, independent of the JAX implementation under
test.  Covers the float path exactly and the 16.16 fixed-point path with
the reference's per-stage ``>> 16`` truncation semantics.

Deliberately dumb-and-direct: per-pixel float32 checks, per-candidate NMS
loops, per-keypoint sampling loops — no shared code with akaze_jax beyond
the config constants that define the format.
"""

from __future__ import annotations

import math

import numpy as np

from golden import (gauss_half_kernel, sep_conv2d, sep_conv2d_fixed,
                    scharr_xy, nld_step, percentile_contrast,
                    fed_tau_by_process_time)

FMIN = -1.0e6
IMIN = -(1 << 30)
SCHARR_FAC1 = 1.0 / (2.0 * (10.0 / 3.0 + 2.0))
SCHARR_FAC2 = (10.0 / 3.0) * SCHARR_FAC1
IFAC1 = int(SCHARR_FAC1 * 65536 + 0.5)
IFAC2 = int(SCHARR_FAC2 * 65536 + 0.5)


def _radius_for_ksize(ksz):
    for lim, r in ((5, 2), (7, 3), (9, 4), (11, 5)):
        if ksz <= lim:
            return r
    raise ValueError(ksz)


def _gauss_fixed(var, radius):
    return [int(v * 65536 + 0.5) for v in gauss_half_kernel(var, radius)]


def _lowpass(x, var, ksz, fixed):
    r = _radius_for_ksize(ksz)
    if fixed:
        return sep_conv2d_fixed(x, _gauss_fixed(var, r))
    return sep_conv2d(x, gauss_half_kernel(var, r))


def _percentile_contrast_fixed(grad, per):
    """Fixed-point histogram percentile (akazed.cu:4098-4172): max floored
    at 1, 16.16-quantized bin factor applied with >> 16, integer-division
    result k * max // 300."""
    mx = max(1, int(grad.max()))
    hf = int(np.float32(300) / np.float32(mx) * 65536 + 0.5)
    bins = np.clip((grad.astype(np.int64) * hf) >> 16, 0, 299)
    hist = np.bincount(bins.ravel(), minlength=300)
    thresh = int(np.float32(grad.size - hist[0]) * np.float32(per))
    cum, k = 0, 1
    while k < 300:
        if cum >= thresh:
            break
        cum += hist[k]
        k += 1
    return k * mx // 300


def _scharr_mag(x, fixed):
    dx, dy = scharr_xy(x.astype(np.int64 if fixed else np.float32), 1)
    # the reference squares in int, converts to f32, and sqrts in f32
    m = np.sqrt((dx * dx + dy * dy).astype(np.float32))
    if fixed:
        return (m + np.float32(0.5)).astype(np.int64)
    return m


def _conductivity(smooth, kcontrast, fixed):
    """PM_G2 flow (gFlowNaive, akazed.cu:1068-1107)."""
    dx, dy = scharr_xy(smooth.astype(np.int64 if fixed else np.float32), 1)
    if fixed:
        ikc = 1.0 / np.float32(kcontrast * kcontrast)
        dif2 = (dx * dx + dy * dy).astype(np.float32) * ikc
        g = 1.0 / (1.0 + dif2)
        return (g * 65536 + 0.5).astype(np.int64)
    ikc = np.float32(1.0) / np.float32(kcontrast * kcontrast)
    dif2 = ikc * (dx * dx + dy * dy).astype(np.float32)
    return (1.0 / (1.0 + dif2)).astype(np.float32)


def _nld_step_fixed(img, flow, tau):
    stepfac = np.int64(0.5 * np.float32(tau) * 65536 + 0.5)
    h, w = img.shape

    def ref(i, m):
        i = np.abs(i)
        return np.where(i >= m, 2 * m - 2 - i, i)

    rows, cols = np.arange(h), np.arange(w)
    up, dn = ref(rows - 1, h), ref(rows + 1, h)
    lf, rt = ref(cols - 1, w), ref(cols + 1, w)
    img = img.astype(np.int64)
    flow = flow.astype(np.int64)
    step = ((flow + flow[:, rt]) * (img[:, rt] - img)
            + (flow + flow[:, lf]) * (img[:, lf] - img)
            + (flow + flow[dn, :]) * (img[dn, :] - img)
            + (flow + flow[up, :]) * (img[up, :] - img)) >> 16
    return ((stepfac * step) >> 16) + img


def _deriv(x, step, fixed):
    """gDerivate normalized first derivatives (akazed.cu:1267-1296)."""
    h, w = x.shape

    def ref(i, m):
        i = np.abs(i)
        return np.where(i >= m, 2 * m - 2 - i, i)

    xi = ref(np.arange(w)[None, :] + step, w)
    xl = ref(np.arange(w)[None, :] - step, w)
    yu = ref(np.arange(h)[:, None] - step, h)
    yd = ref(np.arange(h)[:, None] + step, h)
    rows = np.arange(h)[:, None]
    cols = np.arange(w)[None, :]
    if fixed:
        x = x.astype(np.int64)
        lx = (IFAC1 * (x[yu, xi] + x[yd, xi] - x[yu, xl] - x[yd, xl])
              + IFAC2 * (x[rows, xi] - x[rows, xl])) >> 16
        ly = (IFAC1 * (x[yd, xi] + x[yd, xl] - x[yu, xi] - x[yu, xl])
              + IFAC2 * (x[yd, cols] - x[yu, cols])) >> 16
        return lx, ly
    x = x.astype(np.float32)
    f1, f2 = np.float32(SCHARR_FAC1), np.float32(SCHARR_FAC2)
    lx = f1 * (x[yu, xi] + x[yd, xi] - x[yu, xl] - x[yd, xl]) \
        + f2 * (x[rows, xi] - x[rows, xl])
    ly = f1 * (x[yd, xi] + x[yd, xl] - x[yu, xi] - x[yu, xl]) \
        + f2 * (x[yd, cols] - x[yu, cols])
    return lx.astype(np.float32), ly.astype(np.float32)


def _hessian_det(lx, ly, step, fixed):
    dxx, dxy = _deriv(lx, step, fixed)
    dyx, dyy = _deriv(ly, step, fixed)
    return dxx * dyy - dxy * dxy


def build_scale_space_golden(img, cfg, fixed=False):
    """Returns (octaves, kcontrast): octaves is a list of dicts with
    stacked L/det/lx/ly [S, H, W] plus static sizes."""
    soffset = cfg["soffset"]
    ms = cfg["max_scale"]
    df = cfg["derivative_factor"]
    per = cfg["per"]
    tau_max = cfg["tau_max"]
    reorder = cfg["reordering"]

    # octave shapes with <80px early stop
    h, w = img.shape
    shapes = [(w, h)]
    for _ in range(1, cfg["noctaves"]):
        w2, h2 = shapes[-1][0] >> 1, shapes[-1][1] >> 1
        if w2 < 80 or h2 < 80:
            break
        shapes.append((w2, h2))

    octaves = []
    last_etime = 0.5 * soffset * soffset
    kcontrast = None
    prev_L_last = None
    for oi, (wo, ho) in enumerate(shapes):
        planes = {"L": [], "det": [], "lx": [], "ly": [], "size": [],
                  "sigma_size": [], "border": []}
        L_prev = None
        for j in range(ms):
            if oi == 0 and j == 0:
                esigma = soffset
                size = esigma * df
                taus = []
                pre = _lowpass(img, 1.0, 5, fixed)
                mag = _scharr_mag(pre, fixed)
                kcontrast = (_percentile_contrast_fixed(mag, per) if fixed
                             else percentile_contrast(mag, per))
                ksz = 2 * math.ceil((soffset - 0.8) / 0.3) + 3
                L = _lowpass(img, soffset * soffset, ksz, fixed)
                smooth = L
            else:
                esigma = soffset * (2.0 ** (j / float(ms) + oi))
                curr = 0.5 * esigma * esigma
                taus = fed_tau_by_process_time(curr - last_etime, 1,
                                               tau_max, reorder)
                last_etime = curr
                size = esigma * df / (1 << oi)
                if j == 0:
                    if fixed:
                        kcontrast = int(np.float32(kcontrast) * 0.75 + 0.5)
                    else:
                        kcontrast = np.float32(kcontrast * np.float32(0.75))
                    dst, smooth = _down_with_smooth(prev_L_last, fixed)
                    src = dst
                else:
                    smooth = _lowpass(L_prev, 1.0, 5, fixed)
                    src = L_prev
                flow = _conductivity(smooth, kcontrast, fixed)
                L = src
                for tau in taus:
                    L = (_nld_step_fixed(L, flow, tau) if fixed
                         else nld_step(L, flow, tau).astype(np.float32))
            sigma_size = int(size + 0.5)
            lx, ly = _deriv(smooth, sigma_size, fixed)
            det = _hessian_det(lx, ly, sigma_size, fixed)
            planes["L"].append(L)
            planes["det"].append(det)
            planes["lx"].append(lx)
            planes["ly"].append(ly)
            planes["size"].append(size)
            planes["sigma_size"].append(sigma_size)
            planes["border"].append(10.0 * math.sqrt(2.0) * sigma_size)
            L_prev = L
        prev_L_last = L_prev
        octaves.append({k: (np.stack(v) if k in ("L", "det", "lx", "ly")
                            else v) for k, v in planes.items()})
    return octaves, kcontrast


def _down_with_smooth(src, fixed):
    """gDownWithSmooth (akazed.cu:449-511): even-index decimation + sigma=1
    radius-2 smooth with taps on the SOURCE grid."""
    hs, ws = src.shape
    hd, wd = hs >> 1, ws >> 1
    dst = src[0:2 * hd:2, 0:2 * wd:2]

    def ref(i, m):
        i = np.abs(i)
        return np.where(i >= m, 2 * m - 2 - i, i)

    if fixed:
        k = _gauss_fixed(1.0, 2)
        src64 = src.astype(np.int64)
    else:
        k = gauss_half_kernel(1.0, 2)
        src64 = src.astype(np.float32)
    cols = np.arange(wd) * 2
    row = k[0] * src64[:, cols]
    for i in (1, 2):
        row = row + k[i] * (src64[:, ref(cols - 2 * i, ws)]
                            + src64[:, ref(cols + 2 * i, ws)])
    if fixed:
        row = row >> 16
    rows = np.arange(hd) * 2
    sm = k[0] * row[rows, :]
    for i in (1, 2):
        sm = sm + k[i] * (row[ref(rows - 2 * i, hs), :]
                          + row[ref(rows + 2 * i, hs), :])
    if fixed:
        return dst.astype(np.int64), sm >> 16
    return dst.astype(np.float32), sm.astype(np.float32)


def detect_golden(octaves, cfg, h0, w0, fixed=False):
    """Extrema map + circular NMS + row-major selection + refine.

    Returns dict of arrays (x, y, size, layer, response), row-major order.
    """
    ms = cfg["max_scale"]
    threshold = cfg["idthreshold"] if fixed else cfg["dthreshold"]
    minval = IMIN if fixed else FMIN

    resp_full = np.full((h0, w0), minval,
                        np.int64 if fixed else np.float32)
    size_full = np.zeros((h0, w0), np.float32)
    layer_full = np.full((h0, w0), -1, np.int32)
    psz = min(oc["border"][0] * (1 << oi)
              for oi, oc in enumerate(octaves))
    psz = int(psz)
    rmax = max(max(oc["sigma_size"]) for oc in octaves)

    for oi, oc in enumerate(octaves):
        det = oc["det"]
        s, h, w = det.shape
        r = 1 << oi
        # per-scale strict 3x3 maxima inside the border rect
        resp = np.full_like(det, minval)
        xs32 = np.arange(w, dtype=np.float32)
        ys32 = np.arange(h, dtype=np.float32)
        for si in range(s):
            d = det[si]
            b = np.float32(oc["border"][si])
            # border rect (gCalcExtremaMap, akazed.cu:1346-1353), with the
            # reference's float32 trunc-toward-zero semantics per pixel
            x_ok = ((np.trunc(xs32 - b + np.float32(0.5)) - 1 >= 0)
                    & (np.trunc(xs32 + b + np.float32(0.5)) + 1 <= w - 1))
            y_ok = ((np.trunc(ys32 - b + np.float32(0.5)) - 1 >= 0)
                    & (np.trunc(ys32 + b + np.float32(0.5)) + 1 <= h - 1))
            ismax = d > threshold
            for dy2 in (-1, 0, 1):
                for dx2 in (-1, 0, 1):
                    if dy2 == 0 and dx2 == 0:
                        continue
                    nb = np.full_like(d, minval)
                    ylo, yhi = max(0, dy2), min(h, h + dy2)
                    xlo, xhi = max(0, dx2), min(w, w + dx2)
                    nb[ylo - dy2:yhi - dy2, xlo - dx2:xhi - dx2] = \
                        d[ylo:yhi, xlo:xhi]
                    ismax &= d > nb
            ismax &= y_ok[:, None] & x_ok[None, :]
            resp[si][ismax] = d[ismax]
        # deterministic cross-scale winner: lowest scale wins ties;
        # cross-octave merge is strictly-greater (earlier octaves win ties)
        best_s = np.argmax(resp, axis=0)
        best = np.max(resp, axis=0)
        hv = min(h, (h0 + r - 1) // r)
        wv = min(w, (w0 + r - 1) // r)
        Ys = np.arange(hv) * r
        Xs = np.arange(wv) * r
        sub = np.ix_(Ys, Xs)
        bv = best[:hv, :wv]
        sv = best_s[:hv, :wv]
        take = bv > resp_full[sub]
        resp_full[sub] = np.where(take, bv, resp_full[sub])
        sizes_tab = np.asarray(oc["size"], np.float32)
        size_full[sub] = np.where(take, sizes_tab[sv], size_full[sub])
        layer_full[sub] = np.where(take & (bv > threshold),
                                   oi * ms + sv, layer_full[sub])

    # circular NMS over candidates (gNmsRNaive)
    cand = np.argwhere(layer_full >= 0)
    keep = []
    for (y, x) in cand:
        if not (x >= psz and x + psz < w0 and y >= psz and y + psz < h0):
            continue
        fsz = size_full[y, x]
        sqsz = int(fsz * fsz)
        v = resp_full[y, x]
        ok = True
        for i in range(-rmax, rmax + 1):
            for j in range(-rmax, rmax + 1):
                if i == 0 and j == 0:
                    continue
                if i * i + j * j >= sqsz:
                    continue
                yy, xx = y + i, x + j
                if yy < 0 or yy >= h0 or xx < 0 or xx >= w0:
                    continue
                nv = resp_full[yy, xx]
                if nv > v or (nv == v and i <= 0 and j <= 0):
                    ok = False
                    break
            if not ok:
                break
        if ok:
            keep.append((y, x))
    keep = keep[:cfg["max_pts"]]

    # refine (gRefine): 3x3 quadratic on det
    out = {"x": [], "y": [], "size": [], "layer": [], "response": []}
    for (y, x) in keep:
        layer = int(layer_full[y, x])
        oi, si = layer // ms, layer % ms
        d = octaves[oi]["det"][si]
        yo, xo = y >> oi, x >> oi
        if fixed:
            c = int(d[yo, xo])
            v2 = c + c
            dx = (int(d[yo, xo + 1]) - int(d[yo, xo - 1])) >> 1
            dy = (int(d[yo + 1, xo]) - int(d[yo - 1, xo])) >> 1
            dxx = int(d[yo, xo + 1]) + int(d[yo, xo - 1]) - v2
            dyy = int(d[yo + 1, xo]) + int(d[yo - 1, xo]) - v2
            dxy = (int(d[yo + 1, xo + 1]) + int(d[yo - 1, xo - 1])
                   - int(d[yo - 1, xo + 1]) - int(d[yo + 1, xo - 1])) >> 2
            dd = dxx * dyy - dxy * dxy
            idd = np.float32(1.0 / np.float32(dd)) if dd != 0 else \
                np.float32(0.0)
            dst0 = idd * np.float32(dxy * dy - dyy * dx)
            dst1 = idd * np.float32(dxy * dx - dxx * dy)
        else:
            c = np.float32(d[yo, xo])
            v2 = c + c
            dx = np.float32(0.5) * (d[yo, xo + 1] - d[yo, xo - 1])
            dy = np.float32(0.5) * (d[yo + 1, xo] - d[yo - 1, xo])
            dxx = d[yo, xo + 1] + d[yo, xo - 1] - v2
            dyy = d[yo + 1, xo] + d[yo - 1, xo] - v2
            dxy = np.float32(0.25) * (d[yo + 1, xo + 1] + d[yo - 1, xo - 1]
                                      - d[yo - 1, xo + 1]
                                      - d[yo + 1, xo - 1])
            dd = dxx * dyy - dxy * dxy
            idd = np.float32(1.0) / dd if dd != 0 else np.float32(0.0)
            dst0 = idd * (dxy * dy - dyy * dx)
            dst1 = idd * (dxy * dx - dxx * dy)
        ratio = np.float32(1 << oi)
        if -1.0 <= dst0 <= 1.0 and -1.0 <= dst1 <= 1.0:
            fx = ratio * (np.float32(xo) + dst0)
            fy = ratio * (np.float32(yo) + dst1)
        else:
            fx, fy = np.float32(x), np.float32(y)
        out["x"].append(fx)
        out["y"].append(fy)
        out["size"].append(size_full[y, x])
        out["layer"].append(layer)
        out["response"].append(np.float32(resp_full[y, x]))
    return {k: np.asarray(v) for k, v in out.items()}


def _fast_atan2(y, x):
    absx, absy = abs(x), abs(y)
    mx, mn = max(absx, absy), min(absx, absy)
    a = mn / mx if mx != 0 else 0.0
    s = a * a
    r = ((-0.0464964749 * s + 0.15931422) * s - 0.327622764) * s * a + a
    if absy > absx:
        r = math.pi / 2.0 - r
    if x < 0:
        r = math.pi - r
    if y < 0:
        r = -r
    return r


def _sample(plane, y, x):
    h, w = plane.shape
    if 0 <= y < h and 0 <= x < w:
        return plane[y, x]
    return plane.dtype.type(0)


def orient_golden(kp, octaves, ms, fixed=False):
    """gCalcOrient (akazed.cu:1665-1736): 42-bin histogram over the 11x11
    disc, 7-bin circular window, first maximum."""
    layer = int(kp["layer"])
    oi, si = layer // ms, layer % ms
    lx = octaves[oi]["lx"][si]
    ly = octaves[oi]["ly"][si]
    step = int(kp["size"] + 0.5)
    x = int(kp["x"] + 0.5) >> oi
    y = int(kp["y"] + 0.5) >> oi
    resx = np.zeros(42, np.float32)
    resy = np.zeros(42, np.float32)
    for j in range(-5, 6):
        for i in range(-5, 6):
            r2 = i * i + j * j
            if r2 >= 36:
                continue
            gweight = np.float32(math.exp(-r2 * 0.08))
            dx = gweight * np.float32(_sample(lx, y + j * step,
                                              x + i * step))
            dy = gweight * np.float32(_sample(ly, y + j * step,
                                              x + i * step))
            if fixed:
                ang = _fast_atan2(float(dy), float(dx))
            else:
                ang = math.atan2(float(dy), float(dx))
            b = int(np.clip(int(ang * (21.0 / math.pi)) + 21, 0, 41))
            resx[b] += dx
            resy[b] += dy
    re8x = np.asarray([sum(resx[(b + d) % 42] for d in range(7))
                       for b in range(42)], np.float32)
    re8y = np.asarray([sum(resy[(b + d) % 42] for d in range(7))
                       for b in range(42)], np.float32)
    mag = re8x * re8x + re8y * re8y
    best = int(np.argmax(mag))  # first maximum on ties
    angle = _fast_atan2(float(re8y[best]), float(re8x[best]))
    if angle < 0:
        angle += 2.0 * math.pi
    return np.float32(angle)


def describe_golden(kp, angle, octaves, ms, patsize=10, fixed=False):
    """gDescribe2 (akazed.cu:1869-2001): 486 MLDB bits from rotated cell
    means over the 2x2 / 3x3 / 4x4 grids."""
    layer = int(kp["layer"])
    oi, si = layer // ms, layer % ms
    Lp = octaves[oi]["L"][si]
    lxp = octaves[oi]["lx"][si]
    lyp = octaves[oi]["ly"][si]
    iratio = 1.0 / (1 << oi)
    scale = float(int(kp["size"] + 0.5))
    xf = np.float32(kp["x"] * iratio)
    yf = np.float32(kp["y"] * iratio)
    co = np.float32(math.cos(angle))
    si_ = np.float32(math.sin(angle))

    size2 = patsize
    size3 = math.ceil(2.0 * patsize / 3.0)
    size4 = math.ceil(0.5 * patsize)
    winsize = max(3 * size3, 4 * size4)

    acc = np.zeros((29, 3), np.float32)   # [cell, (im, rx, ry)]
    for s in range(winsize * winsize):
        yq = s // winsize
        xq = s - winsize * yq
        m = max(xq, yq)
        l = xq - size2
        k = yq - size2
        xp = int(xf + scale * (k * co - l * si_) + 0.5)
        yp = int(yf + scale * (k * si_ + l * co) + 0.5)
        im = np.float32(_sample(Lp, yp, xp))
        dx = np.float32(_sample(lxp, yp, xp))
        dy = np.float32(_sample(lyp, yp, xp))
        rx = -dx * si_ + dy * co
        ry = dx * co + dy * si_
        if fixed:
            rx = np.float32(int(rx))
            ry = np.float32(int(ry))
        vals = (im, rx, ry)
        if m < 2 * size2:
            c2 = (0 if yq < size2 else 1) * 2 + (0 if xq < size2 else 1)
            for t in range(3):
                acc[c2, t] += vals[t]
        if m < 3 * size3:
            x3 = 0 if xq < size3 else (1 if xq < 2 * size3 else 2)
            y3 = 0 if yq < size3 else (1 if yq < 2 * size3 else 2)
            for t in range(3):
                acc[4 + y3 * 3 + x3, t] += vals[t]
        if m < 4 * size4:
            x4 = (0 if xq < size4 else 1) if xq < 2 * size4 else \
                 (2 if xq < 3 * size4 else 3)
            y4 = (0 if yq < size4 else 1) if yq < 2 * size4 else \
                 (2 if yq < 3 * size4 else 3)
            for t in range(3):
                acc[13 + y4 * 4 + x4, t] += vals[t]

    # comparison emission order (setCompareIndices, akazed.cu:65-159)
    bits = []
    for cells in (range(0, 4), range(4, 13), range(13, 29)):
        cl = list(cells)
        for chan in range(3):
            for a in range(len(cl)):
                for b in range(a + 1, len(cl)):
                    bits.append(acc[cl[a], chan] > acc[cl[b], chan])
    return np.asarray(bits, bool)


def pack_bits_golden(bits):
    """[486] bool -> [16] uint32 little-endian."""
    out = np.zeros(16, np.uint32)
    for t, b in enumerate(bits):
        if b:
            out[t // 32] |= np.uint32(1) << np.uint32(t % 32)
    return out


def full_pipeline_golden(img, cfg, fixed=False):
    """Complete detect+describe oracle.  Returns a dict with keypoint
    arrays plus descriptor words [N, 16] uint32 and angles [N]."""
    octaves, _ = build_scale_space_golden(img, cfg, fixed)
    h0, w0 = img.shape
    kps = detect_golden(octaves, cfg, h0, w0, fixed)
    ms = cfg["max_scale"]
    n = len(kps["x"])
    angles = np.zeros(n, np.float32)
    words = np.zeros((n, 16), np.uint32)
    for i in range(n):
        kp = {k: kps[k][i] for k in kps}
        angles[i] = orient_golden(kp, octaves, ms, fixed)
        bits = describe_golden(kp, angles[i], octaves, ms,
                               patsize=cfg["descriptor_pattern_size"],
                               fixed=fixed)
        words[i] = pack_bits_golden(bits)
    kps["angle"] = angles
    kps["words"] = words
    return kps


DEFAULT_CFG = dict(max_pts=10000, noctaves=4, max_scale=4, per=0.7,
                   soffset=1.6, reordering=True, derivative_factor=1.5,
                   dthreshold=0.001, idthreshold=65, tau_max=0.25,
                   descriptor_pattern_size=10)
