"""Distributed pose-graph optimization: edges sharded over a device mesh.

The PGO companion to sharded_ba.py: pose state (tiny, [N, 3, 3] + [N, 3])
stays replicated; the edge list — the bulk of a large pose graph — is
partitioned across devices.  Each CG matvec evaluates the local edges'
J^T J v contribution and all-reduces the [N, 6] result; the
Gauss-Newton loop runs replicated inside ``shard_map``, kept bit-identical
across devices by the psums.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..geometry.se3 import highest_precision
from ..slam.posegraph import (PoseGraph, _edge_residuals,
                              _huber_irls_weights, _masked_median, _retract)
from .mesh import axis_size, normalize_axes


def pad_edges(graph: PoseGraph, multiple: int) -> PoseGraph:
    """Pad the edge list to a multiple (weight-0 self-edges at node 0)."""
    e = graph.i.shape[0]
    rem = (-e) % multiple
    if rem == 0:
        return graph
    eye = jnp.broadcast_to(jnp.eye(3, dtype=graph.R_ij.dtype), (rem, 3, 3))
    return PoseGraph(
        i=jnp.pad(graph.i, (0, rem)),
        j=jnp.pad(graph.j, (0, rem)),
        R_ij=jnp.concatenate([graph.R_ij, eye]),
        t_ij=jnp.pad(graph.t_ij, ((0, rem), (0, 0))),
        weight=jnp.pad(graph.weight, (0, rem)))


def sharded_optimize_pose_graph(R, t, graph: PoseGraph, mesh: Mesh,
                                iters: int = 10, cg_iters: int = 50,
                                damping: float = 1e-6,
                                axis="data", fixed_mask=None,
                                robust: str = "none",
                                robust_delta: float = 2.0):
    """Gauss-Newton PGO with the edge list sharded over ``mesh[axis]``.

    Args mirror ``slam.optimize_pose_graph``; ``graph`` must be padded to a
    multiple of the mesh axis size (see ``pad_edges``).  ``axis`` may be one
    axis name or an innermost-first hierarchy like ``("chip", "host")``.
    Returns (R, t, final_cost), fully replicated.
    """
    axis = normalize_axes(axis)
    n_dev = axis_size(mesh, axis)
    assert graph.i.shape[0] % n_dev == 0, "pad edges first"
    if fixed_mask is None:
        fixed_mask = jnp.zeros(R.shape[0], bool).at[0].set(True)
    return _run_sharded_pgo(R, t, graph, fixed_mask, mesh=mesh,
                            iters=iters, cg_iters=cg_iters,
                            damping=damping, axis=axis, robust=robust,
                            robust_delta=robust_delta)


# module-level jit: repeated solves at the same (bucketed) shapes reuse one
# compiled program — a per-call jax.jit(closure) recompiled every optimize()
@partial(jax.jit, static_argnames=("mesh", "iters", "cg_iters", "damping",
                                   "axis", "robust", "robust_delta"))
@highest_precision
def _run_sharded_pgo(R, t, graph, fixed_mask, *, mesh, iters, cg_iters,
                     damping, axis, robust="none", robust_delta=2.0):
    n = R.shape[0]

    def cost_local(R, t, g):
        r = _edge_residuals(R, t, g)
        return jax.lax.psum(0.5 * jnp.sum(r * r), axis)

    spec_g = PoseGraph(P(axis), P(axis), P(axis), P(axis), P(axis))

    @partial(shard_map, mesh=mesh,
             in_specs=(P(), P(), spec_g, P()),
             out_specs=(P(), P(), P()), check_vma=False)
    def run_shmap(R, t, g, fixed):
        free = (~fixed).astype(R.dtype)[:, None]

        def gn_step(state, _):
            R, t = state
            if robust in ("huber", "cauchy"):
                # the robust threshold needs the GLOBAL residual-norm
                # median; edge norms are tiny ([E] floats), so gather them
                r_loc = _edge_residuals(R, t, g)
                n_loc = jnp.sqrt(jnp.sum(r_loc * r_loc, axis=-1))
                n_all = jax.lax.all_gather(n_loc, axis).reshape(-1)
                a_all = jax.lax.all_gather(g.weight > 0, axis).reshape(-1)
                delta = jnp.maximum(
                    robust_delta * _masked_median(n_all, a_all), 1e-12)
                if robust == "cauchy":
                    q = n_loc / delta
                    h = jnp.sqrt(1.0 / (1.0 + q * q))
                else:
                    h = jnp.sqrt(jnp.minimum(
                        1.0, delta / jnp.maximum(n_loc, 1e-12)))
            else:
                h = jnp.ones_like(g.weight)

            def r_of_xi(xi):
                R2, t2 = _retract(R, t, xi * free)
                return _edge_residuals(R2, t2, g) * h[:, None]

            xi0 = jnp.zeros((n, 6), R.dtype)
            r0, jvp = jax.linearize(r_of_xi, xi0)
            vjp = jax.linear_transpose(jvp, xi0)

            def matvec(v):
                (jtjv,) = vjp(jvp(v))
                return jax.lax.psum(jtjv, axis) + damping * v

            (grad,) = vjp(r0)
            grad = jax.lax.psum(grad, axis)
            x0 = jax.lax.pcast(jnp.zeros_like(grad), axis, to="varying")
            dx, _ = jax.scipy.sparse.linalg.cg(matvec, -grad, x0=x0,
                                               maxiter=cg_iters)
            dx = dx * free
            R2, t2 = _retract(R, t, dx)

            def cost_h(R, t):
                r = _edge_residuals(R, t, g) * h[:, None]
                return jax.lax.psum(0.5 * jnp.sum(r * r), axis)

            c_old = cost_h(R, t)
            c_new = cost_h(R2, t2)
            better = c_new < c_old
            return (jnp.where(better, R2, R),
                    jnp.where(better, t2, t)), c_new

        state = jax.lax.pcast((R, t), axis, to="varying")
        (R, t), _ = jax.lax.scan(gn_step, state, None, length=iters)
        return R, t, cost_local(R, t, g)

    return run_shmap(R, t, graph, fixed_mask)
