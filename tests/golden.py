"""Independent numpy transliteration of the reference semantics.

Used as the golden model for unit tests (the environment's OpenCV build has
no features2d, so cv2.AKAZE is unavailable).  Each function mirrors the CUDA
kernel cited in its docstring directly in numpy, independently of the JAX
implementation under test.
"""

from __future__ import annotations

import math

import numpy as np


def reflect_idx(i, m):
    """borderAdd / abs mirror indexing (akazed.cu:162-170)."""
    i = np.abs(i)
    return np.where(i >= m, 2 * m - 2 - i, i)


def gauss_half_kernel(var, radius):
    k = np.exp(-np.arange(radius + 1) ** 2 / (2.0 * var))
    k /= k[0] + 2 * k[1:].sum()
    return k


def sep_conv2d(x, k):
    """gConv2d<R> float semantics (akazed.cu:205-290)."""
    r = len(k) - 1
    h, w = x.shape
    row = k[0] * x.astype(np.float64) * 0 + 0.0
    row = k[0] * x
    for i in range(1, r + 1):
        xl = x[:, reflect_idx(np.arange(w) - i, w)]
        xr = x[:, reflect_idx(np.arange(w) + i, w)]
        row = row + k[i] * (xl + xr)
    out = k[0] * row
    for i in range(1, r + 1):
        xu = row[reflect_idx(np.arange(h) - i, h), :]
        xd = row[reflect_idx(np.arange(h) + i, h), :]
        out = out + k[i] * (xu + xd)
    return out


def sep_conv2d_fixed(x, ik):
    """Fixed-point conv with >>16 per pass (akazed.cu:2922-2987)."""
    r = len(ik) - 1
    h, w = x.shape
    x = x.astype(np.int64)
    row = ik[0] * x
    for i in range(1, r + 1):
        xl = x[:, reflect_idx(np.arange(w) - i, w)]
        xr = x[:, reflect_idx(np.arange(w) + i, w)]
        row = row + ik[i] * (xl + xr)
    row = row >> 16
    out = ik[0] * row
    for i in range(1, r + 1):
        xu = row[reflect_idx(np.arange(h) - i, h), :]
        xd = row[reflect_idx(np.arange(h) + i, h), :]
        out = out + ik[i] * (xu + xd)
    return (out >> 16).astype(np.int32)


def scharr_xy(x, step=1):
    """Unnormalized Scharr with reflect-101 (gScharrContrastNaive,
    akazed.cu:644-667)."""
    h, w = x.shape
    xi = reflect_idx(np.arange(w)[None, :] + step, w)
    xl = reflect_idx(np.arange(w)[None, :] - step, w)
    yu = reflect_idx(np.arange(h)[:, None] - step, h)
    yd = reflect_idx(np.arange(h)[:, None] + step, h)
    c = lambda ys, xs: x[ys, xs]
    rows = np.arange(h)[:, None]
    cols = np.arange(w)[None, :]
    dx = 10 * (c(rows, xi) - c(rows, xl)) + 3 * (
        c(yu, xi) + c(yd, xi) - c(yu, xl) - c(yd, xl))
    dy = 10 * (c(yd, cols) - c(yu, cols)) + 3 * (
        c(yd, xl) + c(yd, xi) - c(yu, xl) - c(yu, xi))
    return dx, dy


def nld_step(img, flow, tau):
    """gNldStepNaive (akazed.cu:1241-1264)."""
    h, w = img.shape
    rows = np.arange(h)
    cols = np.arange(w)
    up = reflect_idx(rows - 1, h)
    dn = reflect_idx(rows + 1, h)
    lf = reflect_idx(cols - 1, w)
    rt = reflect_idx(cols + 1, w)
    step = ((flow + flow[:, rt]) * (img[:, rt] - img)
            + (flow + flow[:, lf]) * (img[:, lf] - img)
            + (flow + flow[dn, :]) * (img[dn, :] - img)
            + (flow + flow[up, :]) * (img[up, :] - img))
    return img + 0.5 * tau * step


def percentile_contrast(grad, per):
    """hScharrContrast host scan (akazed.cu:2443-2481)."""
    mx = max(np.float32(0.03), grad.max())
    hf = np.float32(300) / mx
    bins = np.clip((grad * hf).astype(np.int32), 0, 299)
    hist = np.bincount(bins.ravel(), minlength=300)
    thresh = int((grad.size - hist[0]) * per)
    cum, k = 0, 1
    while k < 300:
        if cum >= thresh:
            break
        cum += hist[k]
        k += 1
    return np.float32(k) / hf


def hamming(words1, words2):
    """Exact Hamming distances between packed descriptors."""
    b1 = np.unpackbits(words1.view(np.uint8), axis=1)
    b2 = np.unpackbits(words2.view(np.uint8), axis=1)
    return (b1[:, None, :] != b2[None, :, :]).sum(-1)


def fed_tau_by_process_time(T, M, tau_max, reordering):
    """fed.cpp:41-148 transliteration."""
    t = T / M
    n = int(math.ceil(math.sqrt(3.0 * t / tau_max + 0.25) - 0.5 - 1e-8) + 0.5)
    scale = 3.0 * t / (tau_max * n * (n + 1))
    c = 1.0 / (4.0 * n + 2.0)
    d = scale * tau_max / 2.0
    tauh = [d / math.cos(math.pi * (2 * k + 1) * c) ** 2 for k in range(n)]
    if not reordering:
        return tauh
    kappa = n // 2
    prime = n + 1

    def is_prime(x):
        if x <= 1:
            return False
        for p in range(2, int(math.sqrt(x)) + 1):
            if x % p == 0:
                return False
        return True

    while not is_prime(prime):
        prime += 1
    tau = [0.0] * n
    k = 0
    for l in range(n):
        while ((k + 1) * kappa) % prime - 1 >= n:
            k += 1
        tau[l] = tauh[((k + 1) * kappa) % prime - 1]
        k += 1
    return tau


def match(words1, valid1, words2, valid2, max_dist):
    """Reference 1-NN acceptance over valid train rows: the first minimum
    wins, kept only if strictly below the second minimum and max_dist
    (gHammingMatch / gMatch, akazed.cu:2106, 2207-2231).  Returns
    (index [N1], distance [N1]) with -1 for rejected queries."""
    d = hamming(words1, words2).astype(np.float64)
    d[:, ~np.asarray(valid2, bool)] = np.inf
    n1 = d.shape[0]
    index = np.full(n1, -1, np.int32)
    dist = np.full(n1, -1.0, np.float32)
    for q in range(n1):
        if not valid1[q] or not np.isfinite(d[q]).any():
            continue
        b = int(np.argmin(d[q]))
        rest = np.delete(d[q], b)
        second = rest.min() if rest.size else np.inf
        if d[q, b] < second and d[q, b] < max_dist:
            index[q] = b
            dist[q] = d[q, b]
    return index, dist
