"""Device mesh helpers.

The reference is single-process single-GPU (SURVEY.md §2.5); all scaling in
this framework goes through ``jax.sharding.Mesh`` + NamedSharding, so the
same code runs on a virtual CPU mesh in tests and on the cards of one or
more GPU hosts in production.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh


def normalize_axes(axis) -> tuple:
    """An axis spec (name or sequence of names) as a tuple of names.

    Every sharded component takes ``axis`` as either one mesh axis ("data")
    or a hierarchy ordered innermost-first (("chip", "host")): psums over
    the tuple reduce within a host first, then across hosts.
    """
    return (axis,) if isinstance(axis, str) else tuple(axis)


def axis_size(mesh: Mesh, axis) -> int:
    """Total number of shards over one axis or an axis tuple."""
    return int(np.prod([mesh.shape[a] for a in normalize_axes(axis)]))


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Sequence[str] = ("data",)) -> Mesh:
    """A 1D (or reshaped N-D) mesh over the first ``n_devices`` devices."""
    devs = jax.devices()
    n = n_devices or len(devs)
    if n > len(devs):
        raise ValueError(f"requested {n} devices, have {len(devs)}")
    devs = np.asarray(devs[:n])
    if len(axis_names) == 1:
        shape = (n,)
    else:
        # split n into len(axis_names) roughly equal powers of two
        shape = [1] * len(axis_names)
        i = 0
        while np.prod(shape) < n:
            shape[i % len(shape)] *= 2
            i += 1
        shape = tuple(shape)
    return Mesh(devs.reshape(shape), axis_names)
