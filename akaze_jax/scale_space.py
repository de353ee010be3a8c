"""Nonlinear (FED) scale-space construction.

Replicates the state machine of ``Akazer::detect`` (akaze.cpp:300-439) and
``Akazer::fastDetect`` (akaze.cpp:506-743) as a single pure function.  The
reference serialises ~100 kernel launches with a device sync after each
(akazed.cu:2520 etc.); here the whole pyramid builds inside one jitted XLA
program — octave shapes and FED trip counts are static (see plan.py), the
diffusion inner loop is a ``lax.scan`` over a constant tau table, and the
contrast percentile never leaves the device.

Per sublevel we keep four planes, mirroring the reference's octave scratch
layout (akaze.cpp:315-320 — nldimg / smooth->det / flow->Lx / temp->Ly):

  L    diffused image (descriptor intensity samples)
  det  Hessian determinant response (detection)
  lx   first derivative Lx at the sublevel's sigma step (orientation/descr.)
  ly   first derivative Ly

Derivatives are computed on the sigma=1-smoothed predecessor image exactly
as the reference does (gDerivate src = the ``smooth`` plane;
akaze.cpp:344,423).
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Tuple

import jax
import jax.numpy as jnp

from .config import AkazeConfig
from .ops import (conductivity, conductivity_fixed, down_with_smooth,
                  down_with_smooth_fixed, hessian_determinant,
                  hessian_determinant_fixed, lowpass, lowpass_fixed,
                  nld_step, nld_step_fixed, percentile_contrast,
                  percentile_contrast_fixed, scaled_derivatives,
                  scaled_derivatives_fixed, scharr_magnitude,
                  scharr_magnitude_fixed)
from .plan import PipelinePlan


class OctaveData(NamedTuple):
    """Stacked per-sublevel planes for one octave: each [max_scale, H, W]."""
    L: jax.Array
    det: jax.Array
    lx: jax.Array
    ly: jax.Array


def _diffuse(img, flow, taus: Tuple[float, ...], fixed: bool):
    """Run the FED inner loop (akaze.cpp:383-391) as a scan over a static
    tau table."""
    if not taus:
        return img
    step_fn = nld_step_fixed if fixed else nld_step
    if len(taus) == 1:
        return step_fn(img, flow, taus[0])
    tau_arr = jnp.asarray(taus, jnp.float32)

    def body(carry, tau):
        return step_fn(carry, flow, tau), None

    out, _ = jax.lax.scan(body, img, tau_arr)
    return out


def build_scale_space(image, plan: PipelinePlan, fixed: bool = False
                      ) -> Tuple[List[OctaveData], jax.Array]:
    """Build the nonlinear scale space.

    Args:
      image: [H, W]; float32 in [0, 1] for the float path, int32 in [0, 255]
        for the fixed-point path (the demo never normalises the fast input,
        main.cpp:257-258).
      plan: static plan from ``build_plan``.
      fixed: choose the 16.16 fixed-point flavour.

    Returns:
      (octaves, kcontrast): per-octave stacked planes and the (traced)
      contrast factor after all octave decays.
    """
    cfg = plan.config
    soffset = cfg.soffset

    lowpass_fn = lowpass_fixed if fixed else lowpass
    conduct_fn = conductivity_fixed if fixed else conductivity
    deriv_fn = scaled_derivatives_fixed if fixed else scaled_derivatives
    hess_fn = hessian_determinant_fixed if fixed else hessian_determinant

    octaves: List[OctaveData] = []
    kcontrast = None
    prev_L_last = None

    for oi, oct_plan in enumerate(plan.octaves):
        Ls, dets, lxs, lys = [], [], [], []
        L_prev = None
        for sp in oct_plan.scales:
            if oi == 0 and sp.scale == 0:
                # First sublevel (akaze.cpp:325-353): estimate the contrast
                # percentile on a sigma=1 smooth, then base-smooth the input
                # with sigma = soffset.
                pre = lowpass_fn(image, 1.0, 5)
                mag = (scharr_magnitude_fixed if fixed
                       else scharr_magnitude)(pre)
                pct_fn = (percentile_contrast_fixed if fixed
                          else percentile_contrast)
                kcontrast = pct_fn(mag, cfg.per)
                var = soffset * soffset
                ksz = 2 * math.ceil((soffset - 0.8) / 0.3) + 3
                L = lowpass_fn(image, var, ksz)
                smooth = L  # smooth = copy of nldimg (akaze.cpp:332)
            elif sp.scale == 0:
                # New octave (akaze.cpp:371-391): decay kcontrast, decimate
                # with fused smooth, diffuse the full tau cycle.
                if fixed:
                    kcontrast = (kcontrast.astype(jnp.float32) * 0.75
                                 + 0.5).astype(jnp.int32)
                    dst, smooth = down_with_smooth_fixed(prev_L_last)
                else:
                    kcontrast = kcontrast * jnp.float32(0.75)
                    dst, smooth = down_with_smooth(prev_L_last)
                flow = conduct_fn(smooth, cfg.diffusivity, kcontrast)
                L = _diffuse(dst, flow, sp.taus, fixed)
            else:
                # Next sublevel (akaze.cpp:393-420): sigma=1 smooth of the
                # previous L, conductivity, diffuse.
                smooth = lowpass_fn(L_prev, 1.0, 5)
                flow = conduct_fn(smooth, cfg.diffusivity, kcontrast)
                L = _diffuse(L_prev, flow, sp.taus, fixed)

            lx, ly = deriv_fn(smooth, sp.sigma_size)
            det = hess_fn(lx, ly, sp.sigma_size)
            Ls.append(L)
            dets.append(det)
            lxs.append(lx)
            lys.append(ly)
            L_prev = L

        prev_L_last = L_prev
        octaves.append(OctaveData(L=jnp.stack(Ls), det=jnp.stack(dets),
                                  lx=jnp.stack(lxs), ly=jnp.stack(lys)))

    return octaves, kcontrast
