"""Separable Gaussian convolutions with reflect-101 borders.

The reference implements these as shared-memory CUDA kernels
(gConv2d / gConv2dR2, akazed.cu:205-356; fixed-point variants at
akazed.cu:2786-3076).  The border rule ``abs(i - d)`` on the left and
``borderAdd`` (akazed.cu:162-170) on the right is exactly numpy/JAX
``mode='reflect'`` (reflect-101: the edge sample is not repeated).

Here we express the separable convolution as a static sum of shifted
slices of a reflect-padded array; XLA fuses the whole stencil into a single
vectorised loop, so no explicit kernel is needed.  Half-kernels are static
Python tuples, replacing the ``__constant__ d_lowpass_kernel`` bus
(akazed.cu:193-199).
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Tuple

import jax.numpy as jnp


@lru_cache(maxsize=None)
def gauss_half_kernel(var: float, radius: int) -> Tuple[float, ...]:
    """Normalized half Gaussian kernel [k0..kR].

    Matches createGaussKernel (akazed.cu:2298-2333): k[i] = exp(-i^2/(2 var)),
    normalized so that k0 + 2*sum(k[1:]) == 1.
    """
    denom = 1.0 / (2.0 * var)
    k = [math.exp(-i * i * denom) for i in range(radius + 1)]
    ksum = k[0] + 2.0 * sum(k[1:])
    return tuple(v / ksum for v in k)


@lru_cache(maxsize=None)
def gauss_half_kernel_fixed(var: float, radius: int) -> Tuple[int, ...]:
    """16.16 fixed-point half kernel: int(kf * 65536 + 0.5)
    (akazed.cu:3861-3900)."""
    return tuple(int(v * 65536 + 0.5) for v in gauss_half_kernel(var, radius))


def radius_for_ksize(ksz: int) -> int:
    """Kernel-size -> radius dispatch of hLowPass (akazed.cu:2345-2380)."""
    if ksz <= 5:
        return 2
    if ksz <= 7:
        return 3
    if ksz <= 9:
        return 4
    if ksz <= 11:
        return 5
    raise ValueError("kernels larger than 11 not supported (akazed.cu:2379)")


def _row_pass(xp, k, w):
    """Horizontal stencil over a width-padded array; returns [H, w]."""
    r = len(k) - 1
    out = k[0] * xp[:, r:r + w]
    for i in range(1, r + 1):
        out = out + k[i] * (xp[:, r - i:r - i + w] + xp[:, r + i:r + i + w])
    return out


def _col_pass(xp, k, h):
    r = len(k) - 1
    out = k[0] * xp[r:r + h, :]
    for i in range(1, r + 1):
        out = out + k[i] * (xp[r - i:r - i + h, :] + xp[r + i:r + i + h, :])
    return out


def sep_conv2d(x, half_kernel: Tuple[float, ...]):
    """Separable 2D convolution, float path.  x: [H, W] float32."""
    r = len(half_kernel) - 1
    h, w = x.shape
    k = [jnp.float32(v) for v in half_kernel]
    xp = jnp.pad(x, ((0, 0), (r, r)), mode="reflect")
    row = _row_pass(xp, k, w)
    rowp = jnp.pad(row, ((r, r), (0, 0)), mode="reflect")
    return _col_pass(rowp, k, h)


def sep_conv2d_fixed(x, half_kernel: Tuple[int, ...]):
    """Separable 2D convolution, 16.16 fixed point.

    x: [H, W] int32.  Each pass accumulates int32 products and applies an
    arithmetic ``>> 16`` exactly as the reference does per stage
    (akazed.cu:2812-2850).
    """
    r = len(half_kernel) - 1
    h, w = x.shape
    k = [jnp.int32(v) for v in half_kernel]
    xp = jnp.pad(x, ((0, 0), (r, r)), mode="reflect")
    row = _row_pass(xp, k, w) >> 16
    rowp = jnp.pad(row, ((r, r), (0, 0)), mode="reflect")
    return _col_pass(rowp, k, h) >> 16


def lowpass(x, var: float, ksz: int):
    """hLowPass semantics (akazed.cu:2336-2386): radius from ksz, Gaussian
    from ``var``."""
    radius = radius_for_ksize(ksz)
    return sep_conv2d(x, gauss_half_kernel(var, radius))


def lowpass_fixed(x, var: float, ksz: int):
    """Fixed-point hLowPass (akazed.cu:3963-4013)."""
    radius = radius_for_ksize(ksz)
    return sep_conv2d_fixed(x, gauss_half_kernel_fixed(var, radius))



def _even_cols(x, off: int, n: int):
    """x[:, off : off+2n : 2] without a strided slice (XLA lowers lane
    strides to a ~3 ms relayout at 960x1280; reshape+minor-slice is free)."""
    return x[:, off:off + 2 * n].reshape(x.shape[0], n, 2)[:, :, 0]


def _even_rows(x, off: int, n: int):
    """x[off : off+2n : 2, :] without a strided slice."""
    return x[off:off + 2 * n].reshape(n, 2, x.shape[1])[:, 0, :]


def down_with_smooth(src):
    """2x decimation plus sigma=1 (radius 2) smooth of the decimated grid.

    Matches gDownWithSmooth (akazed.cu:449-511): ``dst`` is the raw
    even-index decimation of ``src``; ``smooth`` applies the radius-2 Gaussian
    *in source coordinates* with taps at +-2, +-4 and reflect-101 borders on
    the source grid.

    Returns (dst, smooth), each [H//2, W//2].
    """
    k = [jnp.float32(v) for v in gauss_half_kernel(1.0, 2)]
    hs, ws = src.shape
    hd, wd = hs >> 1, ws >> 1
    dst = _even_rows(_even_cols(src, 0, wd), 0, hd)

    xp = jnp.pad(src, ((0, 0), (4, 4)), mode="reflect")
    # row filter sampled at even source columns: source col = 2*dix + 2i
    row = k[0] * _even_cols(xp, 4, wd)
    for i in (1, 2):
        row = row + k[i] * (_even_cols(xp, 4 - 2 * i, wd)
                            + _even_cols(xp, 4 + 2 * i, wd))
    rowp = jnp.pad(row, ((4, 4), (0, 0)), mode="reflect")
    smooth = k[0] * _even_rows(rowp, 4, hd)
    for i in (1, 2):
        smooth = smooth + k[i] * (_even_rows(rowp, 4 - 2 * i, hd)
                                  + _even_rows(rowp, 4 + 2 * i, hd))
    return dst, smooth


def down_with_smooth_fixed(src):
    """Fixed-point gDownWithSmooth (akazed.cu:3143-3205), ``>> 16`` per pass."""
    k = [jnp.int32(v) for v in gauss_half_kernel_fixed(1.0, 2)]
    hs, ws = src.shape
    hd, wd = hs >> 1, ws >> 1
    dst = _even_rows(_even_cols(src, 0, wd), 0, hd)

    xp = jnp.pad(src, ((0, 0), (4, 4)), mode="reflect")
    row = k[0] * _even_cols(xp, 4, wd)
    for i in (1, 2):
        row = row + k[i] * (_even_cols(xp, 4 - 2 * i, wd)
                            + _even_cols(xp, 4 + 2 * i, wd))
    row = row >> 16
    rowp = jnp.pad(row, ((4, 4), (0, 0)), mode="reflect")
    smooth = k[0] * _even_rows(rowp, 4, hd)
    for i in (1, 2):
        smooth = smooth + k[i] * (_even_rows(rowp, 4 - 2 * i, hd)
                                  + _even_rows(rowp, 4 + 2 * i, hd))
    return dst, smooth >> 16
