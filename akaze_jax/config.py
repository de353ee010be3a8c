"""Configuration for the AKAZE pipeline.

The reference exposes these parameters through ``Akazer::init``
(reference: akaze.cpp:80-98) with demo defaults at main.cpp:156-166.  Here they
form a hashable, frozen dataclass so that a configuration can be used as a
static argument to ``jax.jit`` — everything derived from it (octave shapes,
FED step tables, border tables) is baked into the compiled program instead of
living in CUDA ``__constant__`` memory (reference: akazed.cu:18-25).
"""

from __future__ import annotations

import dataclasses
import enum


class Diffusivity(enum.IntEnum):
    """Conductivity function g(|grad L|) selecting the diffusion flavour.

    Reference: akaze_structures.h:53-59 and the kernels at akazed.cu:1091-1106.
    """

    PM_G1 = 0
    PM_G2 = 1
    WEICKERT = 2
    CHARBONNIER = 3


@dataclasses.dataclass(frozen=True)
class AkazeConfig:
    """Tuning parameters of the AKAZE detector/descriptor.

    Defaults mirror the reference demo configuration (main.cpp:156-166).
    """

    max_pts: int = 10000            # capacity of the keypoint tensors
    noctaves: int = 4               # pyramid octaves (may shrink for small images)
    max_scale: int = 4              # sublevels per octave
    per: float = 0.7                # percentile for the contrast factor
    kcontrast: float = 0.03         # initial contrast factor
    soffset: float = 1.6            # base scale offset (sigma units)
    reordering: bool = True         # FED step reordering
    derivative_factor: float = 1.5  # multiscale derivative factor
    dthreshold: float = 0.001       # detector response threshold (float path)
    idthreshold: int = 65           # detector response threshold (int path,
                                    # reference: akaze.cpp:560)
    diffusivity: Diffusivity = Diffusivity.PM_G2
    descriptor_pattern_size: int = 10
    tau_max: float = 0.25           # max FED step size (reference: akaze.cpp:268)
    max_dist: int = 96              # Hamming acceptance threshold
                                    # (MAX_DIST, akazed.cu:11)
    # NOTE: there is deliberately no "match rule" knob.  The reference's two
    # matchers — gHammingMatch's strictly-unique minimum (akazed.cu:2207-2231)
    # and gMatch's 1st < 2nd (akazed.cu:2106) — both collapse to
    # "best < second_best and best < max_dist" once lane-aliasing artifacts
    # are removed (see match.py's module docstring), so one matcher serves
    # both.

    # smax scale multiplier for the extrema border; 10*sqrt(2) for the MLDB
    # descriptor family (FEATURE_TYPE 5; reference: akaze.cpp:277-285).
    @property
    def smax(self) -> float:
        return 10.0 * (2.0 ** 0.5)

    def __post_init__(self):
        if self.max_scale < 1 or self.max_scale > 5:
            raise ValueError("max_scale must be in [1, 5]")
        if self.noctaves < 1:
            raise ValueError("noctaves must be >= 1")


DESCRIPTOR_BITS = 486     # 3 channels x (C(4,2) + C(9,2) + C(16,2)) comparisons
DESCRIPTOR_BYTES = 61     # ceil(486 / 8); reference: akaze_structures.h:29
DESCRIPTOR_WORDS = 16     # 486 bits padded into 16 uint32 words (512 lanes)
