"""Multi-host distributed runtime: process bootstrap, (host, chip) meshes,
and hierarchical collectives.

The reference's device-management tier (cuda_utils.h:41-67: device query /
selection / stream setup) is single-process single-GPU; the equivalent
here is a *multi-process* runtime in which every host drives its
locally-attached cards and XLA's collectives ride the right interconnect:

  * the ``chip`` mesh axis spans the cards of one host — psums over it
    stay inside the host's NVLink domain;
  * the ``host`` axis spans processes — psums over it cross the network.

Layouts therefore put the high-traffic axis on ``chip`` and only
low-bandwidth summaries (e.g. the [C, 6] camera-side reductions of
distributed BA) on ``host``.  A ``lax.psum`` over ``("chip", "host")``
lowers to exactly this hierarchy when the mesh's device order is
host-major, which ``make_host_chip_mesh`` guarantees: JAX orders
``jax.devices()`` by process, so reshaping to (hosts, chips_per_host) puts
each row's devices on one host.

Single-process use (tests, the virtual CPU mesh) works unchanged: a
(1, n)-shaped host/chip mesh or a purely local mesh both produce the same
programs, so all the sharded components can be exercised without a cluster
and deployed on one with only the bootstrap call added.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh

HOST_AXIS = "host"
CHIP_AXIS = "chip"
# psum order: innermost (within a host) first, then across hosts
HIER_AXES = (CHIP_AXIS, HOST_AXIS)


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           local_device_ids=None) -> bool:
    """Bootstrap the multi-process JAX runtime (idempotent).

    Mirrors the role of the reference's device-selection entry point
    (cuda_utils.h:41-67) for a fleet: every process calls this with the
    same coordinator address before any device use; afterwards
    ``jax.devices()`` is the *global* device list and ``jax.process_index()``
    identifies this host.

    Args default from the standard env vars (JAX_COORDINATOR_ADDRESS,
    JAX_NUM_PROCESSES, JAX_PROCESS_ID) so launchers can configure via the
    environment.  Returns True if the distributed runtime was initialized,
    False when running single-process (no coordinator configured).
    """
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS")
    if coordinator_address is None:
        return False
    if num_processes is None:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None:
        process_id = int(os.environ["JAX_PROCESS_ID"])
    is_init = getattr(jax.distributed, "is_initialized", None)
    if is_init is not None and is_init():  # already up (public API)
        return True
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
            local_device_ids=local_device_ids)
    except RuntimeError as e:  # older JAX: no is_initialized() probe
        if "already initialized" not in str(e).lower():
            raise
    return True


def make_host_chip_mesh(num_hosts: Optional[int] = None,
                        chips_per_host: Optional[int] = None,
                        axis_names: Sequence[str] = HIER_AXES[::-1]) -> Mesh:
    """A 2-axis ("host", "chip") mesh over the global device list.

    Device order from ``jax.devices()`` is process-major, so row h of the
    mesh holds exactly the cards of host h: collectives over ``chip`` stay
    on-host (NVLink), collectives over ``host`` cross the network once per
    chip rank.  On one host with four cards the mesh is (1, 4).

    In a single-process run this still works (num_hosts=1 unless overridden)
    so the same program shapes compile on the virtual CPU mesh.
    """
    devs = jax.devices()
    if num_hosts is None:
        num_hosts = max(jax.process_count(), 1)
    if chips_per_host is None:
        chips_per_host = len(devs) // num_hosts
    n = num_hosts * chips_per_host
    if n > len(devs):
        raise ValueError(
            f"requested {num_hosts}x{chips_per_host} devices, "
            f"have {len(devs)}")
    grid = np.asarray(devs[:n]).reshape(num_hosts, chips_per_host)
    return Mesh(grid, tuple(axis_names))


def hier_psum(x, axes: Sequence[str] = HIER_AXES):
    """All-reduce over a hierarchical mesh: within a host first, then
    across hosts.

    ``lax.psum`` accepts the axis tuple directly; listing the chip axis
    first documents the reduce-locally-then-cross-hosts schedule.  Works for single axes too.
    """
    live = tuple(a for a in axes)
    return jax.lax.psum(x, live)


def mesh_axes(mesh: Mesh) -> tuple:
    """The mesh's axis names as a tuple (helper for axis-generic psums)."""
    return tuple(mesh.axis_names)


def process_local_batch(global_batch: int) -> int:
    """Per-process share of a globally-sized batch (data loading helper:
    each host feeds only its addressable shard)."""
    n = max(jax.process_count(), 1)
    assert global_batch % n == 0, "process count must divide global batch"
    return global_batch // n
