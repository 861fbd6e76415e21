"""Collapsed-bound sparse GP regression (Titsias) — port of
``vggp_tpu/models/sgpr.py``: one model over every feature family (points,
VFF, B1/B2/B3 splines, cells of every kernel kind on uniform or non-uniform
meshes), which makes it the reference's SVGP / VFF / ASVGP / GriddedGP zoo
by feature choice, in 1-D or Kronecker d-D, with a Gaussian likelihood and
an optional learned constant mean. With cell features on the mesh of
interest this is the paper's GriddedGP, whose optimal q(u) is the gridded
product itself.

Math (the stable factored form of ``models.common.factored_state``):
    A  = F⁻¹ Kuf / σ   (Khatri–Rao over the axes; Kuu = F Fᵀ per axis)
    B  = I + A Aᵀ,  L_B = chol(B),  c = L_B⁻¹ A y / σ
    ELBO = −n/2·log(2πσ²) − Σ log diag L_B − (yᵀy/σ² − cᵀc)/2
           − (Σ k_ff − σ²‖A‖²_F) / (2σ²)
Every head propagates Cholesky factors; ``precompute`` caches the
training-set state (chols, A, L_B, c) so that the ``*_from_state`` heads cost
only query-size work.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

import torch

from vggp_tpu_torch import config
from vggp_tpu_torch.config import highest_precision
from vggp_tpu_torch.models import common
from vggp_tpu_torch.models.common import Gaussian
from vggp_tpu_torch.ops.chol import tri_solve
from vggp_tpu_torch.ops.kron import kron_dense, kron_diag

Params = Dict

@dataclass(frozen=True)
class SGPRSpec:
    """Static config: per-axis kernel kinds and inducing features."""

    kinds: Tuple[str, ...]
    features: Tuple
    jitter: float = 1e-6
    factor_method: str = "chol"     # Kuu factorization: "chol" | "eigh"
    per_output_noise: bool = False  # a noise level per output (needs a coregion axis)
    learn_mean: bool = False        # a learned constant mean; per output with a coregion axis

    def __post_init__(self):
        if self.factor_method not in ("chol", "eigh"):
            raise ValueError(f"unknown factor method {self.factor_method!r}")

    @property
    def ndim(self) -> int:
        return len(self.kinds)

    @property
    def num_inducing(self) -> int:
        return math.prod(f.m for f in self.features)

    def init_params(self, dtype=torch.float32, device=None) -> Params:
        """:func:`common.init_tree`: σ² = ℓ = 1 per continuous axis and the
        feature's own (a point feature's z, a coregion axis's W and κ), noise
        0.1 and the mean 0 when it is learned, each per output where asked,
        on ``cuda`` unless ``device`` is given."""
        return common.init_tree(self.kinds, self.features, self.per_output_noise,
                                self.learn_mean, dtype, config.resolve_device(device))


@highest_precision
def precompute(spec: SGPRSpec, params: Params, X: torch.Tensor, y: torch.Tensor):
    """The training-set state (chols, A, L_B, c): one O(n·m²) pass, after
    which every ``*_from_state`` head is O(n*·m²) in the query size only.
    Rebuild it after any parameter update."""
    return common.factored_state(spec, params, X, y)[:4]


@highest_precision
def posterior_from_state(spec: SGPRSpec, params: Params, state, xstar: torch.Tensor,
                         full_cov: bool = False, predictive: bool = False) -> Gaussian:
    """q(f*) from a :func:`precompute` state: no training-data pass."""
    return common.collapsed_posterior(spec, params, state, xstar, full_cov=full_cov,
                                      predictive=predictive)


def _grid_gaussian_from_state(spec: SGPRSpec, state, kvu_blocks, kvv_blocks,
                              full_cov: bool) -> Gaussian:
    """A grid-product posterior from a factored state and the per-axis cross
    and prior blocks: R = ⊗(Kvu_i F_i⁻ᵀ), T = R L_B⁻ᵀ, mean = Tc,
    cov = Kvv − RRᵀ + TTᵀ (per-cell variances alone for ``full_cov=False``).
    Shared by the q(v) and q(∂v) heads."""
    chols, _, LB, c = state[:4]
    R = kron_dense([chols[i].whiten(kvu_blocks[i].T).T for i in range(spec.ndim)])
    T = tri_solve(LB, R.T).T
    mean = T @ c
    if full_cov:
        return Gaussian(mean=mean, cov=kron_dense(kvv_blocks) - R @ R.T + T @ T.T)
    kvv_diag = kron_diag([torch.diagonal(b) for b in kvv_blocks])
    var = kvv_diag - torch.sum(R * R, dim=1) + torch.sum(T * T, dim=1)
    return Gaussian(mean=mean, var=common.floor_var(var, kvv_diag))


@highest_precision
def q_v_from_state(spec: SGPRSpec, params: Params, state, grid_axes: Sequence,
                   full_cov: bool = False) -> Gaussian:
    """q(v) over the cells of ``grid_axes`` from a :func:`precompute` state."""
    kvu_blocks = common.grid_kvu(spec, params, grid_axes)
    kvv_blocks = common.grid_kvv(spec, params, grid_axes, dense=False)
    g = _grid_gaussian_from_state(spec, state, kvu_blocks, kvv_blocks, full_cov)
    return common.shift_mean(g, common.grid_mean(spec, params, grid_axes))


@highest_precision
def q_dv_from_state(spec: SGPRSpec, params: Params, state, grid_axes: Sequence, axis: int,
                    full_cov: bool = False) -> Gaussian:
    """q(∫_cell ∂f/∂x_axis) from a :func:`precompute` state: on ``axis`` a
    face difference of Kuf at the cell edges (``cell_kuf`` at (m, g + 1)),
    cell integrals elsewhere. Divide by the cell measure for the
    mean-gradient field."""
    kvu_blocks = common.grad_grid_kvu(spec, params, grid_axes, axis)
    kvv_blocks = common.grad_grid_kvv(spec, params, grid_axes, axis, dense=False)
    return _grid_gaussian_from_state(spec, state, kvu_blocks, kvv_blocks, full_cov)


@highest_precision
def posterior_grad_from_state(spec: SGPRSpec, params: Params, state, xstar: torch.Tensor,
                              axis: int, full_cov: bool = False) -> Gaussian:
    """The posterior of the pointwise gradient ∂f/∂x_axis from a
    :func:`precompute` state: :func:`posterior_from_state`'s algebra with
    the axis block F⁻¹∂Kuf/∂x and the prior −k″(0)·Πσ². Needs a
    once-differentiable kind on ``axis`` (Matérn-1/2 raises ValueError)."""
    return common.collapsed_posterior(
        spec, params, state, xstar, full_cov=full_cov,
        kdiag_fn=lambda s, p, x: common.grad_kdiag(s, p, x, axis),
        gram_fn=lambda s, p, x1, x2: common.grad_gram_full(s, p, x1, x2, axis),
        blocks_fn=lambda s, p, ch, x: common.axis_whitened_dkuf(s, p, ch, x, axis))


@highest_precision
def posterior_grad(spec: SGPRSpec, params: Params, X: torch.Tensor, y: torch.Tensor,
                   xstar: torch.Tensor, axis: int, full_cov: bool = False) -> Gaussian:
    """The pointwise-gradient posterior (:func:`posterior_grad_from_state`)
    on a fresh state."""
    return posterior_grad_from_state(spec, params, precompute(spec, params, X, y), xstar,
                                     axis, full_cov=full_cov)


@highest_precision
def elbo(spec: SGPRSpec, params: Params, X: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The collapsed (Titsias) evidence lower bound, a scalar, in O(n·m²).
    With gradients wanted the whitened blocks take the scalar-tangent route
    (``cell_kuf_with_dl``, one launch per axis); otherwise ``cell_kuf``."""
    return common.collapsed_elbo(spec, params, X, y)


def loss(spec: SGPRSpec, params: Params, X: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return -elbo(spec, params, X, y)


@highest_precision
def posterior(spec: SGPRSpec, params: Params, X: torch.Tensor, y: torch.Tensor,
              xstar: torch.Tensor, full_cov: bool = True, predictive: bool = False) -> Gaussian:
    """q(f*) at ``xstar``: :func:`posterior_from_state` on a fresh state."""
    return common.collapsed_posterior(spec, params, common.factored_state(spec, params, X, y),
                                      xstar, full_cov=full_cov, predictive=predictive)


def posterior_predictive(spec: SGPRSpec, params: Params, X: torch.Tensor, y: torch.Tensor,
                         xstar: torch.Tensor, full_cov: bool = True) -> Gaussian:
    return posterior(spec, params, X, y, xstar, full_cov=full_cov, predictive=True)


def prior(spec: SGPRSpec, params: Params, xstar: torch.Tensor) -> Gaussian:
    """Prior N(m, K**) at ``xstar``."""
    cov = common.gram_full(spec, params, xstar, xstar)
    mean = torch.zeros(cov.shape[0], dtype=cov.dtype, device=cov.device)
    return Gaussian(mean=mean + common.mean_fn(spec, params, xstar), cov=cov)


@highest_precision
def q_u(spec: SGPRSpec, params: Params, X: torch.Tensor, y: torch.Tensor) -> Gaussian:
    """The optimal q(u) = N(F L_B⁻ᵀ c, F B⁻¹ Fᵀ), F = ⊗F_i: PSD by
    construction, with a dense (m, m) covariance."""
    chols, _, LB, c = precompute(spec, params, X, y)
    half = tri_solve(LB, kron_dense([f.F for f in chols]).T).T    # F L_B⁻ᵀ
    return Gaussian(mean=half @ c, cov=half @ half.T)


@highest_precision
def q_v(spec: SGPRSpec, params: Params, X: torch.Tensor, y: torch.Tensor,
        grid_axes: Sequence, full_cov: bool = True) -> Gaussian:
    """The gridded posterior q(v) over cell integrals v_i = ∫_cell_i f:
    mean = R L_B⁻ᵀ c, cov = Kvv − RRᵀ + TTᵀ with R = Kvu F⁻ᵀ, T = R L_B⁻ᵀ.
    On the model's own cells it is q(u)."""
    return q_v_from_state(spec, params, precompute(spec, params, X, y), grid_axes, full_cov)


@highest_precision
def q_dv(spec: SGPRSpec, params: Params, X: torch.Tensor, y: torch.Tensor,
         grid_axes: Sequence, axis: int, full_cov: bool = True) -> Gaussian:
    """The gridded-gradient posterior (:func:`q_dv_from_state`)."""
    return q_dv_from_state(spec, params, precompute(spec, params, X, y), grid_axes, axis,
                           full_cov)


@highest_precision
def p_v_u(spec: SGPRSpec, params: Params, X: torch.Tensor, y: torch.Tensor,
          grid_axes: Sequence) -> Gaussian:
    """p(v | u = E_q[u]): mean R L_B⁻ᵀ c, cov Kvv − RRᵀ, dense (g, g)."""
    chols, _, LB, c = precompute(spec, params, X, y)
    kvu_blocks = common.grid_kvu(spec, params, grid_axes)
    R = kron_dense([chols[i].whiten(kvu_blocks[i].T).T for i in range(spec.ndim)])
    mean = tri_solve(LB, R.T).T @ c
    cov = common.grid_kvv(spec, params, grid_axes, dense=True) - R @ R.T
    return common.shift_mean(Gaussian(mean=mean, cov=cov),
                             common.grid_mean(spec, params, grid_axes))


class SGPR(common.HeldDataModule):
    """The collapsed GP as a module (:class:`common.HeldDataModule`):
    ``forward()`` is the loss; the heads condition on the held data."""

    def forward(self) -> torch.Tensor:
        """The loss (negative collapsed ELBO) on the held data."""
        return loss(self.spec, self.params(), self.X, self.y)

    def posterior(self, xstar: torch.Tensor, full_cov: bool = False,
                  predictive: bool = False) -> Gaussian:
        return posterior(self.spec, self.params(), self.X, self.y, xstar, full_cov=full_cov,
                         predictive=predictive)

    def precompute(self):
        return precompute(self.spec, self.params(), self.X, self.y)

    def q_u(self) -> Gaussian:
        return q_u(self.spec, self.params(), self.X, self.y)

    def q_v(self, grid_axes=None, full_cov: bool = False) -> Gaussian:
        """The gridded product; ``grid_axes`` defaults to the model's own cells."""
        return q_v(self.spec, self.params(), self.X, self.y, grid_axes or self.spec.features,
                   full_cov)

    def q_dv(self, grid_axes=None, axis: int = 0, full_cov: bool = False) -> Gaussian:
        """The gridded-gradient product along ``axis``; ``grid_axes``
        defaults to the model's own cells."""
        return q_dv(self.spec, self.params(), self.X, self.y, grid_axes or self.spec.features,
                    axis, full_cov)
