"""Image-processing ops for the AKAZE pipeline.

Each op is a pure function over dense arrays; XLA fuses the elementwise
pipelines that the reference expresses as separate CUDA kernels.
"""

from .conv import (gauss_half_kernel, gauss_half_kernel_fixed, lowpass,
                   lowpass_fixed, sep_conv2d, sep_conv2d_fixed,
                   down_with_smooth, down_with_smooth_fixed)
from .scharr import (scharr_gradient_xy, scharr_magnitude,
                     scharr_magnitude_fixed, scaled_derivatives,
                     scaled_derivatives_fixed, hessian_determinant,
                     hessian_determinant_fixed)
from .contrast import percentile_contrast, percentile_contrast_fixed
from .diffusion import conductivity, conductivity_fixed, nld_step, nld_step_fixed

__all__ = [
    "gauss_half_kernel", "gauss_half_kernel_fixed", "lowpass", "lowpass_fixed",
    "sep_conv2d", "sep_conv2d_fixed", "down_with_smooth",
    "down_with_smooth_fixed", "scharr_gradient_xy", "scharr_magnitude",
    "scharr_magnitude_fixed", "scaled_derivatives", "scaled_derivatives_fixed",
    "hessian_determinant", "hessian_determinant_fixed", "percentile_contrast",
    "percentile_contrast_fixed", "conductivity", "conductivity_fixed",
    "nld_step", "nld_step_fixed",
]
