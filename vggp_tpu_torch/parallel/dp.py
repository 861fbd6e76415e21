"""Sharded SVGP training, prediction and streaming over a device mesh (port of
``vggp_tpu/parallel/dp.py`` on ``torch.distributed``).

Data parallelism: each process takes its contiguous block of the minibatch
(:func:`shard_batch`, the JAX package's ``P('data')`` layout) and computes
the loss on it; the ELBO is a sum over the points, so the mean of the
processes' losses and gradients over the ``data`` axis is the whole batch's.
Model parallelism over the Kronecker axes of the variational state: μ
(m₁, …, m_d) is split over one mesh axis a grid axis, raw_L_i (m_i, m_i) by
rows over its own. Each process stores its slices and the optimizer state of
its slices only; a step all-gathers the whole state over the model axes,
differentiates it, all-reduces the gradient over the data axis and keeps its
own slice. Adam is elementwise, so the sliced optimizer takes the slice of
the whole one's step.

The JAX package writes no collectives (GSPMD inserts them); here each one is
written out: one all-reduce a step over the data axis, one all-gather a
sharded leaf over its model axes.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from vggp_tpu_torch import streaming, train
from vggp_tpu_torch.models import svgp


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where a parameter leaf lives on the mesh: one mesh-axis name (or None)
    a tensor dimension, split into equal contiguous blocks by the axis's
    coordinate; ``()`` replicates the leaf (the JAX package's
    ``PartitionSpec``)."""

    axes: Tuple[Optional[str], ...] = ()


def _axis_size(mesh, axis: str) -> int:
    return mesh.shape[mesh.mesh_dim_names.index(axis)]


def _check_axis(mesh, axis: str) -> None:
    if axis not in mesh.mesh_dim_names:
        raise ValueError(f"mesh has no axis {axis!r}: {mesh.mesh_dim_names}")


def _all_gather(t: torch.Tensor, group, size: int, dim: int) -> torch.Tensor:
    """The blocks of ``t`` of every process of ``group``, concatenated along
    ``dim`` in rank order (the mesh coordinate's order)."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(size)]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


def _local(t: torch.Tensor, mesh, placement: Placement) -> torch.Tensor:
    """This process's block of the whole tensor ``t``."""
    for dim, axis in enumerate(placement.axes):
        if axis is not None:
            size = t.shape[dim] // _axis_size(mesh, axis)
            t = t.narrow(dim, mesh.get_local_rank(axis) * size, size)
    return t


def _whole(t: torch.Tensor, mesh, placement: Placement) -> torch.Tensor:
    """The whole tensor from every process's block ``t``."""
    for dim, axis in enumerate(placement.axes):
        if axis is not None:
            t = _all_gather(t, mesh.get_group(axis), _axis_size(mesh, axis), dim)
    return t


def _resolve_model_axes(spec, mesh, model_axis: Optional[str],
                        model_axes: Optional[Sequence[Optional[str]]]) -> Tuple:
    """One mesh axis (or None) a Kronecker grid axis: ``model_axes``
    right-padded with None, else the legacy ``model_axis`` on the second
    grid axis. A named axis is dropped (that grid axis replicated) when the
    mesh lacks it, its size is 1, or it does not divide m_i."""
    ndim = spec.ndim
    if model_axes is None:
        model_axes = (None, model_axis) if ndim >= 2 else (None,)
    axes = list(model_axes)[:ndim]
    axes += [None] * (ndim - len(axes))
    for i, a in enumerate(axes):
        if a is None:
            continue
        if a not in mesh.mesh_dim_names or _axis_size(mesh, a) == 1:
            axes[i] = None
        elif spec.variational == "kron" and spec.axis_m[i] % _axis_size(mesh, a) != 0:
            axes[i] = None
    return tuple(axes)


def _param_pspec(spec, params: Dict, model_axes: Tuple[Optional[str], ...]) -> Dict:
    """Placements of the raw parameter tree: μ over every named model axis,
    each raw_L_i by rows over its own, everything else replicated."""
    pspec = train.tree_map(lambda _: Placement(), params)
    if spec.variational == "kron" and any(a is not None for a in model_axes):
        q = dict(pspec["q"])
        q["mu"] = Placement(tuple(model_axes))
        for i, a in enumerate(model_axes):
            if a is not None:
                q[f"raw_L{i + 1}"] = Placement((a, None))
        pspec = {**pspec, "q": q}
    return pspec


def shard_params(params: Dict, mesh, pspec_tree: Dict) -> Dict:
    """This process's blocks of ``params`` under ``pspec_tree``'s placements
    (fresh tensors)."""
    leaves = iter(train.tree_leaves(pspec_tree))
    return train.tree_map(lambda v: _local(v, mesh, next(leaves)).clone(), params)


def shard_batch(xb: torch.Tensor, yb: torch.Tensor, mesh, data_axis: str = "data"):
    """This process's rows of the batch: rows [r·n/p, (r+1)·n/p) at data
    coordinate r of p. Raises ``ValueError`` when p does not divide n."""
    _check_axis(mesh, data_axis)
    p, n = _axis_size(mesh, data_axis), yb.shape[0]
    if n % p != 0:
        raise ValueError(f"{n} points do not split over the {p} processes of axis "
                         f"{data_axis!r}")
    lo = mesh.get_local_rank(data_axis) * (n // p)
    return xb[lo:lo + n // p], yb[lo:lo + n // p]


def make_sharded_svgp_step(
    spec: svgp.SVGPSpec,
    optimizer: Callable[[list], torch.optim.Optimizer],
    mesh,
    data_axis: str = "data",
    model_axis: str | None = "model",
    model_axes: Optional[Sequence[Optional[str]]] = None,
):
    """Build (init_fn, step_fn) for a data- and model-sharded SVGP step.

    ``optimizer(leaves)`` makes the optimizer over a list of leaves, e.g.
    ``lambda ps: torch.optim.Adam(ps, lr=0.05)``. ``init_fn(params)`` takes
    constrained params and returns (raw, opt_state): this process's blocks
    of the raw tree and the optimizer over them.
    ``step_fn(raw, opt_state, xb, yb) -> (raw, opt_state, loss)`` takes this
    process's rows of the batch (:func:`shard_batch`) and returns the whole
    batch's loss; the raw blocks are updated in place.

    ``model_axes`` names one mesh axis per Kronecker grid axis (entries may
    be None; shorter tuples are right-padded with None). The legacy
    ``model_axis`` shards the second axis only and is ignored when
    ``model_axes`` is given. A named axis is dropped (state replicated — DP
    still applies) when it is absent from the mesh, has size 1, or does not
    divide the corresponding inducing-grid size.

    The step is skipped whole, optimizer state included, when the loss or
    any gradient is not finite; every process reads that from the reduced
    loss and gradients, so all of them take or skip the step together.
    """
    _check_axis(mesh, data_axis)
    model_axes = _resolve_model_axes(spec, mesh, model_axis, model_axes)
    data_group, p_data = mesh.get_group(data_axis), _axis_size(mesh, data_axis)

    def init_fn(params: Dict):
        raw = train.unconstrain(params)
        raw = train.tree_map(lambda v: v.detach().requires_grad_(True),
                             shard_params(raw, mesh, _param_pspec(spec, raw, model_axes)))
        return raw, optimizer(train.tree_leaves(raw))

    def step_fn(raw, opt_state, xb, yb):
        leaves = train.tree_leaves(raw)
        placements = train.tree_leaves(_param_pspec(spec, raw, model_axes))
        whole = [_whole(v.detach(), mesh, pl).requires_grad_(True)
                 for v, pl in zip(leaves, placements, strict=True)]
        it = iter(whole)
        val = svgp.loss(spec, train.constrain(train.tree_map(lambda _: next(it), raw)), xb, yb)
        val.backward()
        # one all-reduce of the loss and every gradient over the data axis
        grads = [w.grad for w in whole if w.grad is not None]
        flat = torch.cat([val.detach().reshape(1)] + [g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=data_group)
        flat = flat / p_data
        parts = iter(torch.split(flat[1:], [g.numel() for g in grads]))
        for w in whole:
            if w.grad is not None:
                w.grad = next(parts).view_as(w)
        for v, w, pl in zip(leaves, whole, placements):
            v.grad = None if w.grad is None else _local(w.grad, mesh, pl).clone()
        loss = flat[0]
        train.guarded_update(opt_state, whole, loss)
        return raw, opt_state, loss

    return init_fn, step_fn


def _whole_tree(raw: Dict, mesh, pspec: Dict) -> Dict:
    leaves = iter(train.tree_leaves(pspec))
    return train.tree_map(lambda v: _whole(v.detach(), mesh, next(leaves)), raw)


def make_sharded_qv(
    spec: svgp.SVGPSpec,
    mesh,
    grid_axes,
    full_cov: bool = False,
    model_axis: str | None = "model",
    model_axes: Optional[Sequence[Optional[str]]] = None,
):
    """Gridded-prediction head over the sharded variational state.

    ``fn(raw) -> Gaussian`` takes the raw tree as
    :func:`make_sharded_svgp_step` leaves it (give the same ``model_axis``
    or ``model_axes``), gathers the model-sharded blocks and returns q(v),
    the same on every process."""
    model_axes = _resolve_model_axes(spec, mesh, model_axis, model_axes)

    @torch.no_grad()
    def qv_fn(raw):
        whole = _whole_tree(raw, mesh, _param_pspec(spec, raw, model_axes))
        return svgp.q_v(spec, train.constrain(whole), grid_axes, full_cov=full_cov)

    return qv_fn


def make_sharded_assimilate(
    spec: svgp.SVGPSpec,
    params: Dict,
    mesh,
    data_axis: str = "data",
    heteroscedastic: bool = False,
):
    """Data-parallel streaming assimilation over ``mesh``.

    Returned ``fn(state, xb, yb[, noise]) -> state`` takes this process's
    rows of the chunk (:func:`shard_batch`, and its block of the per-point
    noise when ``heteroscedastic``) and a state that is the same on every
    process. Each process folds its rows into a zero state, the increments
    Λ += A D⁻¹ Aᵀ, η += A D⁻¹ y and the point count are all-reduced over the
    data axis, and the sum is added to the state: the result is the
    unsharded update's, on every process. Hyperparameters are closed over
    (they define the whitening and must be identical across the stream).
    """
    _check_axis(mesh, data_axis)
    group = mesh.get_group(data_axis)

    def fold(state, xb, yb, noise):
        zero = {k: torch.zeros_like(v) for k, v in state.items()}
        incr = streaming.assimilate(spec, params, zero, xb, yb, noise=noise)
        for v in incr.values():
            dist.all_reduce(v, group=group)
        return {k: state[k] + incr[k] for k in state}

    if heteroscedastic:
        def fn(state, xb, yb, noise):
            return fold(state, xb, yb, noise)
    else:
        def fn(state, xb, yb):
            return fold(state, xb, yb, None)
    return fn
