"""Exact GP regression with a separable product kernel, gridded q(v) and
q(∂v) heads and the pointwise-gradient posterior — port of
``vggp_tpu/models/exact.py`` for continuous kernel kinds. Every operation is
Cholesky-factored: the marginal likelihood is one O(n³/3) factorization of
Kxx + σ²I.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

import torch

from vggp_tpu_torch import config, kernels
from vggp_tpu_torch.config import highest_precision
from vggp_tpu_torch.models import common
from vggp_tpu_torch.models.common import Gaussian
from vggp_tpu_torch.ops.chol import safe_cholesky, tri_solve
from vggp_tpu_torch.ops.kron import kron_dense, kron_diag

Params = Dict

@dataclass(frozen=True)
class ExactGPSpec:
    kinds: Tuple[str, ...]           # one per input axis; product kernel across axes
    jitter: float = 1e-6
    # a multi-output model: a "coregion" axis whose column of X carries the
    # output index (ICM, K = B ⊗ ⊗K_i), with n_outputs outputs of B's rank
    n_outputs: int = 0
    coregion_rank: int = 1
    per_output_noise: bool = False   # noise becomes an (n_outputs,) vector
    learn_mean: bool = False         # a learned constant mean; per output with a coregion axis

    @property
    def ndim(self) -> int:
        return len(self.kinds)

    def init_params(self, dtype=torch.float32, device=None) -> Params:
        """σ² = ℓ = 1 per continuous axis, W and κ of
        ``OutputFeature(n_outputs, coregion_rank)`` on a coregion axis, noise
        0.1 and the mean 0 when it is learned, each per output where asked,
        on ``cuda`` unless ``device`` is given."""
        from vggp_tpu_torch.features import AxisFeature, OutputFeature

        feats = tuple(OutputFeature(self.n_outputs, self.coregion_rank)
                      if kind == kernels.COREGION_KIND else AxisFeature() for kind in self.kinds)
        return common.init_tree(self.kinds, feats, self.per_output_noise, self.learn_mean,
                                dtype, config.resolve_device(device), self.n_outputs)


def _chol_ky(spec: ExactGPSpec, params: Params, X: torch.Tensor) -> torch.Tensor:
    kxx = common.gram_full(spec, params, X, X)
    n = kxx.shape[0]
    noise = common.obs_noise(spec, params, X)
    return safe_cholesky(kxx + noise * torch.eye(n, dtype=kxx.dtype, device=kxx.device),
                         spec.jitter)


def _residual(spec, params, X, y):
    return y.reshape(-1) - common.mean_fn(spec, params, X)


@highest_precision
def mll(spec: ExactGPSpec, params: Params, X: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """log p(y | X, θ) = log N(y | 0, Kxx + σ²I)."""
    y = _residual(spec, params, X, y)
    L = _chol_ky(spec, params, X)
    alpha = tri_solve(L, y)
    n = y.shape[0]
    return (-0.5 * torch.sum(alpha * alpha) - torch.sum(torch.log(torch.diagonal(L)))
            - 0.5 * n * math.log(2.0 * math.pi))


def loss(spec: ExactGPSpec, params: Params, X: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return -mll(spec, params, X, y)


def prior(spec: ExactGPSpec, params: Params, xstar: torch.Tensor) -> Gaussian:
    cov = common.gram_full(spec, params, xstar, xstar)
    mean = torch.zeros(cov.shape[0], dtype=cov.dtype, device=cov.device)
    return Gaussian(mean=mean + common.mean_fn(spec, params, xstar), cov=cov)


@highest_precision
def posterior(spec: ExactGPSpec, params: Params, X: torch.Tensor, y: torch.Tensor,
              xstar: torch.Tensor, full_cov: bool = True, predictive: bool = False) -> Gaussian:
    y = _residual(spec, params, X, y)
    L = _chol_ky(spec, params, X)
    w = tri_solve(L, common.gram_full(spec, params, X, xstar))       # (n, n*)
    mean = w.T @ tri_solve(L, y) + common.mean_fn(spec, params, xstar)
    noise = common.obs_noise(spec, params, xstar) if predictive else 0.0
    if full_cov:
        cov = common.gram_full(spec, params, xstar, xstar) - w.T @ w
        if predictive:
            cov = cov + noise * torch.eye(cov.shape[0], dtype=cov.dtype, device=cov.device)
        return Gaussian(mean=mean, cov=cov)
    kss = common.kdiag(spec, params, xstar)
    return Gaussian(mean=mean,
                    var=common.floor_var(kss - torch.sum(w * w, dim=0), kss) + noise)


def posterior_predictive(spec: ExactGPSpec, params: Params, X: torch.Tensor, y: torch.Tensor,
                         xstar: torch.Tensor, full_cov: bool = True) -> Gaussian:
    return posterior(spec, params, X, y, xstar, full_cov=full_cov, predictive=True)


def _kvx(spec: ExactGPSpec, params: Params, grid_axes, X: torch.Tensor) -> torch.Tensor:
    """(g, n) Cov[v_i, f(x_j)]: per-axis cell/point covariances (the
    ``cell_kuf`` kernel), Khatri–Rao."""
    if X.dim() == 1:
        X = X[:, None]
    return common.khatri_rao_all([grid_axes[i].Kuf(kind, common.axis_params(params, i), X[:, i])
                                  for i, kind in enumerate(spec.kinds)])


def _grid_marginal(y, L, kvx, kvv_blocks, full_cov: bool) -> Gaussian:
    """The grid marginal of the joint Gaussian (v, y): mean Kvx Ky⁻¹ y,
    cov Kvv − Kvx Ky⁻¹ Kvxᵀ, through w = L⁻¹Kvxᵀ."""
    w = tri_solve(L, kvx.T)                      # (n, g)
    mean = w.T @ tri_solve(L, y)
    if full_cov:
        return Gaussian(mean=mean, cov=kron_dense(kvv_blocks) - w.T @ w)
    kvv_diag = kron_diag([torch.diagonal(b) for b in kvv_blocks])
    return Gaussian(mean=mean,
                    var=common.floor_var(kvv_diag - torch.sum(w * w, dim=0), kvv_diag))


@highest_precision
def q_v(spec: ExactGPSpec, params: Params, X: torch.Tensor, y: torch.Tensor,
        grid_axes: Sequence, full_cov: bool = True) -> Gaussian:
    """The posterior over grid-cell integrals, the exact marginal of (v, y)
    (the reference's extra ``+ Kvx p(f|y)cov⁻¹ Kvxᵀ`` term is not part of
    it and is not replicated, as in the JAX package)."""
    y = _residual(spec, params, X, y)
    L = _chol_ky(spec, params, X)
    kvv_blocks = [grid_axes[i].Kuu(kind, common.axis_params(params, i))
                  for i, kind in enumerate(spec.kinds)]
    g = _grid_marginal(y, L, _kvx(spec, params, grid_axes, X), kvv_blocks, full_cov)
    return common.shift_mean(g, common.grid_mean(spec, params, grid_axes))


@highest_precision
def q_dv(spec: ExactGPSpec, params: Params, X: torch.Tensor, y: torch.Tensor,
         grid_axes: Sequence, axis: int, full_cov: bool = True) -> Gaussian:
    """The posterior over grid-cell integrals of ∂f/∂x_axis: on ``axis`` a
    face difference of point Grams at the cell edges (the fundamental
    theorem of calculus, valid for every kind), the cell/point covariance
    (``cell_kuf``) on the other axes."""
    axis = common.canonical_axis(spec, axis)
    y = _residual(spec, params, X, y)
    Xd = X[:, None] if X.dim() == 1 else X
    L = _chol_ky(spec, params, X)
    blocks = []
    for i, kind in enumerate(spec.kinds):
        p = common.axis_params(params, i)
        if i == axis:
            g = kernels.gram_1d(kind, grid_axes[i].mesh_j(p), Xd[:, i], p["variance"],
                                p["lengthscale"])
            blocks.append(g[1:, :] - g[:-1, :])
        else:
            blocks.append(grid_axes[i].Kuf(kind, p, Xd[:, i]))
    kvv_blocks = common.grad_grid_kvv(spec, params, grid_axes, axis, dense=False)
    return _grid_marginal(y, L, common.khatri_rao_all(blocks), kvv_blocks, full_cov)


@highest_precision
def posterior_grad(spec: ExactGPSpec, params: Params, X: torch.Tensor, y: torch.Tensor,
                   xstar: torch.Tensor, axis: int, full_cov: bool = False) -> Gaussian:
    """The posterior of ∂f/∂x_axis: Cov(∂f(x*), f(X)) factorises per axis
    (k′ on ``axis``, k elsewhere); mean that block times (Kxx + σ²I)⁻¹y,
    variance from −k″(0)·Πσ². Needs a once-differentiable kind on ``axis``
    (Matérn-1/2 raises ValueError)."""
    axis = common.canonical_axis(spec, axis)
    kernels.require_differentiable(spec.kinds[axis])
    y = _residual(spec, params, X, y)
    Xs = xstar[:, None] if xstar.dim() == 1 else xstar
    Xd = X[:, None] if X.dim() == 1 else X
    L = _chol_ky(spec, params, X)
    kdx = None   # (n*, n) Cov(∂f(x*), f(X))
    for i, kind in enumerate(spec.kinds):
        p = common.axis_params(params, i)
        if i == axis:
            g = kernels.dgram_1d(kind, Xs[:, i], Xd[:, i], p["variance"], p["lengthscale"])
        else:
            g = kernels.axis_gram(kind, p, Xs[:, i], Xd[:, i])
        kdx = g if kdx is None else kdx * g
    w = tri_solve(L, kdx.T)                  # (n, n*)
    mean = w.T @ tri_solve(L, y)
    if full_cov:
        return Gaussian(mean=mean,
                        cov=common.grad_gram_full(spec, params, xstar, xstar, axis) - w.T @ w)
    kss = common.grad_kdiag(spec, params, xstar, axis)
    return Gaussian(mean=mean, var=common.floor_var(kss - torch.sum(w * w, dim=0), kss))


class ExactGP(common.HeldDataModule):
    """The exact GP as a module (:class:`common.HeldDataModule`):
    ``forward()`` is the loss; the heads condition on the held data."""

    def forward(self) -> torch.Tensor:
        """The loss (negative log marginal likelihood) on the held data."""
        return loss(self.spec, self.params(), self.X, self.y)

    def posterior(self, xstar: torch.Tensor, full_cov: bool = False,
                  predictive: bool = False) -> Gaussian:
        return posterior(self.spec, self.params(), self.X, self.y, xstar, full_cov=full_cov,
                         predictive=predictive)

    def q_v(self, grid_axes: Sequence, full_cov: bool = False) -> Gaussian:
        return q_v(self.spec, self.params(), self.X, self.y, grid_axes, full_cov)

    def q_dv(self, grid_axes: Sequence, axis: int = 0, full_cov: bool = False) -> Gaussian:
        return q_dv(self.spec, self.params(), self.X, self.y, grid_axes, axis, full_cov)
