"""Data-sharded matrix-free CG heads (port of ``vggp_tpu/parallel/cg.py`` on
``torch.distributed``).

Both hot contractions of the matrix-free path (``models.iterative``) are
sums over the data:

    b      = Kuf y            — a sum over the n axis,
    G @ w  = σ²Kuu w + Kuf (Kufᵀ w)   — the KufKufᵀ term sums over n.

So the data axis is split: each process builds the per-axis (m_i, n/p) Kuf
blocks of its own rows of X, the w-tensor stays whole on every process, and
each contraction over n is a partial sum plus one all-reduce over the
``data`` axis (``iterative.DataShard``). The structured Kuu matvecs and the
preconditioners act on the whole w-tensor, so every process takes the same
iterates and the same stopping decision. Three places need more than a
reduction, and take it from the shard: the KMS gate reads the number of all
the points, the KMS-Woodbury preconditioner (whose S couples every pair of
points) is built from the gathered Kuf blocks, and a sampler draws every
point's ε from its generator and keeps its own block, so the draws are the
unsharded run's.

Every ``make_sharded_*`` here returns a function of (params, X, y, …) that
takes this process's rows of the data (``dp.shard_batch``) and returns the
result the unsharded head returns, the same on every process.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist

from vggp_tpu_torch.models import iterative
from vggp_tpu_torch.parallel.dp import _all_gather, _axis_size, _check_axis


def _data_shard(mesh, data_axis: str, n_local: int) -> iterative.DataShard:
    """This process's block of ``n_local`` rows of the data axis."""
    _check_axis(mesh, data_axis)
    group, p = mesh.get_group(data_axis), _axis_size(mesh, data_axis)

    def reduce(t: torch.Tensor) -> torch.Tensor:
        t = t.contiguous()
        dist.all_reduce(t, group=group)
        return t

    return iterative.DataShard(
        reduce=reduce, gather=lambda t: _all_gather(t, group, p, t.dim() - 1),
        n=n_local * p, start=mesh.get_local_rank(data_axis) * n_local)


def make_sharded_solve_w(
    spec,
    mesh,
    data_axis: str = "data",
    tol: Optional[float] = None,
    maxiter: int = 1000,
):
    """``fn(params, X, y, return_info=False) -> w``: the CG solve of
    ``iterative.solve_w`` with the data split over ``data_axis``; the flat
    (m,) ``w`` (and the info) is every process's, ready for any of the
    ``*_from_w`` heads. The contractions' partial sums reduce in another
    order than the unsharded sums, and cond(G) amplifies that through the
    iterates: the JAX package holds its sharded solve to 1e-6 relative."""
    iterative._check_spec(spec)

    def fn(params, X, y, return_info=False):
        return iterative.solve_w(spec, params, X, y, tol=tol, maxiter=maxiter,
                                 return_info=return_info,
                                 shard=_data_shard(mesh, data_axis, y.shape[0]))

    return fn


def make_sharded_qv_mean_cg(
    spec,
    mesh,
    grid_axes: Sequence,
    data_axis: str = "data",
    tol: Optional[float] = None,
    maxiter: int = 1000,
):
    """``fn(params, X, y) -> E_q[v]`` (flat): the sharded solve and the
    gridded product's mean head."""
    solve = make_sharded_solve_w(spec, mesh, data_axis, tol, maxiter)
    grid_axes = tuple(grid_axes)

    def fn(params, X, y):
        return iterative.q_v_mean_from_w(spec, params, grid_axes, solve(params, X, y))

    return fn


def make_sharded_qdv_mean_cg(
    spec,
    mesh,
    grid_axes: Sequence,
    axis: int,
    data_axis: str = "data",
    tol: Optional[float] = None,
    maxiter: int = 1000,
):
    """``fn(params, X, y) -> E_q[∫_cell ∂f/∂x_axis]`` (flat): the sharded
    solve and the gridded-gradient product's mean (the face-difference
    ``iterative.q_dv_mean_from_w``, every kind). Divide by the cell measure
    for velocities."""
    solve = make_sharded_solve_w(spec, mesh, data_axis, tol, maxiter)
    grid_axes = tuple(grid_axes)

    def fn(params, X, y):
        return iterative.q_dv_mean_from_w(spec, params, grid_axes, axis, solve(params, X, y))

    return fn


def make_sharded_pathwise_qv(
    spec,
    mesh,
    grid_axes: Sequence,
    data_axis: str = "data",
    n_samples: int = 64,
    n_features: int = 1024,
    **cg_kwargs,
):
    """``fn(params, X, y, gen) -> Gaussian(mean, var)``: the matrix-free
    pathwise q(v) head (``iterative.q_v_pathwise``), data-sharded. The prior
    paths and the ε draws come from ``gen``, which must be in the same state
    on every process; the draws are those of the unsharded head from the
    same state. The samples are not split: every draw touches all the
    data."""
    iterative._check_spec(spec, pathwise=True)
    grid_axes = tuple(grid_axes)

    def fn(params, X, y, gen: torch.Generator):
        return iterative.q_v_pathwise(spec, params, X, y, grid_axes, gen, n_samples=n_samples,
                                      n_features=n_features,
                                      shard=_data_shard(mesh, data_axis, y.shape[0]),
                                      **cg_kwargs)

    return fn


def make_sharded_pathwise_qdv(
    spec,
    mesh,
    grid_axes: Sequence,
    axis: int,
    data_axis: str = "data",
    n_samples: int = 64,
    n_features: int = 1024,
    **cg_kwargs,
):
    """``fn(params, X, y, gen) -> Gaussian(mean, var)``: the matrix-free
    gridded-gradient uncertainty head (``iterative.q_dv_pathwise``),
    data-sharded as :func:`make_sharded_pathwise_qv`."""
    iterative._check_spec(spec, pathwise=True)
    grid_axes = tuple(grid_axes)

    def fn(params, X, y, gen: torch.Generator):
        return iterative.q_dv_pathwise(spec, params, X, y, grid_axes, axis, gen,
                                       n_samples=n_samples, n_features=n_features,
                                       shard=_data_shard(mesh, data_axis, y.shape[0]),
                                       **cg_kwargs)

    return fn
