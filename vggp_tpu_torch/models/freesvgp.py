"""Collapsed sparse GP with free d-dimensional inducing points — port of
``vggp_tpu/models/freesvgp.py``. m free points z_i ∈ ℝᵈ under the
separable product kernel: Kuu is the m×m Hadamard product of the
per-dimension Grams (free points do not factorize over the axes), Kuf
likewise, in the stable factored form

    A = L⁻¹Kuf/σ, B = I + AAᵀ, L_B = chol B, c = L_B⁻¹Ay/σ

(O(n·m²)). z is learned: autograd runs through the Cholesky of Kuu and the
whitening. No cell kernel is on this path; every block is plain torch, as
the JAX package computes it in jnp.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from vggp_tpu_torch import config, kernels
from vggp_tpu_torch.config import highest_precision
from vggp_tpu_torch.features import _cell_point_cov
from vggp_tpu_torch.models import common
from vggp_tpu_torch.models.common import Gaussian
from vggp_tpu_torch.ops.chol import psd_factor, safe_cholesky, tri_solve
from vggp_tpu_torch.ops.kron import khatri_rao_rows, kron_dense, kron_diag

Params = Dict


@dataclass(frozen=True)
class FreeSVGPSpec:
    """Static config: the per-dimension kernel kinds and the number of free
    points."""

    kinds: Tuple[str, ...]
    m: int
    jitter: float = 1e-6

    @property
    def ndim(self) -> int:
        return len(self.kinds)

    @property
    def num_inducing(self) -> int:
        return self.m

    def init_params(self, dtype=torch.float32, device=None, z_init: np.ndarray = None,
                    seed: int = 0) -> Params:
        """σ² = ℓ = 1 per dimension, noise 0.1 and z uniform on [0, 1]^d
        from ``numpy.random.default_rng(seed)`` (the JAX package's draw)
        unless ``z_init`` is given, on ``cuda`` unless ``device`` is given."""
        device = config.resolve_device(device)
        scalar = lambda v: torch.tensor(v, dtype=dtype, device=device)
        if z_init is None:
            z_init = np.random.default_rng(seed).random((self.m, self.ndim))
        return {"axes": tuple({"variance": scalar(1.0), "lengthscale": scalar(1.0)}
                              for _ in self.kinds),
                "z": torch.as_tensor(np.asarray(z_init), dtype=dtype, device=device),
                "noise": scalar(0.1)}


def _hadamard_gram(spec, params: Params, z1: torch.Tensor, z2: torch.Tensor) -> torch.Tensor:
    """Π_d k_d(z1[:, d], z2[:, d]): the separable kernel on free points."""
    out = None
    for d, kind in enumerate(spec.kinds):
        p = common.axis_params(params, d)
        g = kernels.gram_1d(kind, z1[:, d], z2[:, d], p["variance"], p["lengthscale"])
        out = g if out is None else out * g
    return out


def _factored_state(spec: FreeSVGPSpec, params: Params, X: torch.Tensor, y: torch.Tensor):
    """(chol, A, L_B, c, y). In float32 the Kuu jitter is floored at the
    smallest of the kinds' floors (``common.KIND_JITTER_F32``); the n-term
    sums of B and A·y accumulate in float64 (``common.gram_accumulated``)."""
    y = y.reshape(-1)
    sigma = torch.sqrt(params["noise"])
    z = params["z"]
    kuu = _hadamard_gram(spec, params, z, z)
    jitter = spec.jitter
    if kuu.dtype != torch.float64:
        jitter = max(jitter, min(common.KIND_JITTER_F32.get(k, 1e-4) for k in spec.kinds))
    chol = psd_factor(kuu, method="chol", jitter=jitter)
    A = chol.whiten(_hadamard_gram(spec, params, z, X)) / sigma
    B, Ay = common.gram_accumulated(A, y / sigma)
    LB = safe_cholesky(B, 1e-12)
    return chol, A, LB, tri_solve(LB, Ay), y


@highest_precision
def elbo(spec: FreeSVGPSpec, params: Params, X: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The collapsed (Titsias) bound in O(n·m²)."""
    _, A, LB, c, y = _factored_state(spec, params, X, y)
    n = y.shape[0]
    noise = params["noise"]
    kff_sum = torch.sum(common.kdiag(spec, params, X))
    qff_tr = noise * torch.sum(A * A)
    bound = -0.5 * n * torch.log(2.0 * torch.pi * noise)
    bound = bound - torch.sum(torch.log(torch.diagonal(LB)))
    bound = bound - 0.5 * torch.sum(y * y) / noise
    bound = bound + 0.5 * torch.sum(c * c)
    return bound - common.nonneg(kff_sum - qff_tr) / (2.0 * noise)


def loss(spec: FreeSVGPSpec, params: Params, X: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return -elbo(spec, params, X, y)


@highest_precision
def posterior(spec: FreeSVGPSpec, params: Params, X: torch.Tensor, y: torch.Tensor,
              xstar: torch.Tensor, full_cov: bool = False, predictive: bool = False) -> Gaussian:
    """q(f*) at ``xstar``."""
    chol, _, LB, c, _ = _factored_state(spec, params, X, y)
    w = chol.whiten(_hadamard_gram(spec, params, params["z"], xstar))
    return common.conditional(w, LB, c, lambda: _hadamard_gram(spec, params, xstar, xstar),
                              lambda: common.kdiag(spec, params, xstar), full_cov,
                              params["noise"] if predictive else 0.0)


def posterior_predictive(spec, params, X, y, xstar, full_cov: bool = False) -> Gaussian:
    return posterior(spec, params, X, y, xstar, full_cov=full_cov, predictive=True)


def prior(spec: FreeSVGPSpec, params: Params, xstar: torch.Tensor) -> Gaussian:
    """Prior N(0, K**) of the separable product kernel at ``xstar``."""
    cov = _hadamard_gram(spec, params, xstar, xstar)
    return Gaussian(mean=torch.zeros(cov.shape[0], dtype=cov.dtype, device=cov.device), cov=cov)


@highest_precision
def q_u(spec: FreeSVGPSpec, params: Params, X: torch.Tensor, y: torch.Tensor) -> Gaussian:
    """The optimal q(u) = N(F L_B⁻ᵀ c, F B⁻¹ Fᵀ) over the free points."""
    chol, _, LB, c, _ = _factored_state(spec, params, X, y)
    half = tri_solve(LB, chol.F.T).T          # F L_B⁻ᵀ
    return Gaussian(mean=half @ c, cov=half @ half.T)


def _kvu(spec, params: Params, grid_axes, axis: int = None) -> torch.Tensor:
    """(Π g_d, m) Kvu: the row-wise Khatri–Rao product of the per-dimension
    cell/point covariances ∫_cell k_d(t, z_jd) dt; on ``axis`` (the gradient
    heads) the face difference of k_d at the cell edges instead."""
    z = params["z"]
    out = None
    for d, kind in enumerate(spec.kinds):
        p = common.axis_params(params, d)
        mesh = grid_axes[d].mesh_j(p)
        if d == axis:
            g = kernels.gram_1d(kind, mesh, z[:, d], p["variance"], p["lengthscale"])
            b = g[1:, :] - g[:-1, :]
        else:
            b = _cell_point_cov(kind, mesh, z[:, d], p["variance"], p["lengthscale"])
        out = b if out is None else khatri_rao_rows(out, b)
    return out


def _grid_gaussian(spec, params, X, y, grid_axes, kvv_blocks, axis, full_cov) -> Gaussian:
    """R = Kvu F⁻ᵀ, T = R L_B⁻ᵀ: mean Tc, cov Kvv − RRᵀ + TTᵀ (the
    Kronecker diagonal alone without ``full_cov``)."""
    chol, _, LB, c, _ = _factored_state(spec, params, X, y)
    R = chol.whiten(_kvu(spec, params, grid_axes, axis).T).T
    T = tri_solve(LB, R.T).T
    if full_cov:
        return Gaussian(mean=T @ c, cov=kron_dense(kvv_blocks) - R @ R.T + T @ T.T)
    kvv_diag = kron_diag([torch.diagonal(b) for b in kvv_blocks])
    var = kvv_diag - torch.sum(R * R, dim=1) + torch.sum(T * T, dim=1)
    return Gaussian(mean=T @ c, var=common.floor_var(var, kvv_diag))


@highest_precision
def q_v(spec: FreeSVGPSpec, params: Params, X: torch.Tensor, y: torch.Tensor,
        grid_axes: Sequence, full_cov: bool = False) -> Gaussian:
    """The gridded posterior over the B0 cell integrals of the product-kernel
    field: Kvu[(i₁, i₂), j] = Π_d ∫_{cell i_d} k_d(t, z_jd) dt, without the
    cartesian grid of z products."""
    return _grid_gaussian(spec, params, X, y, grid_axes,
                          common.grid_kvv(spec, params, grid_axes, dense=False), None, full_cov)


@highest_precision
def q_dv(spec: FreeSVGPSpec, params: Params, X: torch.Tensor, y: torch.Tensor,
         grid_axes: Sequence, axis: int, full_cov: bool = False) -> Gaussian:
    """The gridded-gradient posterior ∫_cell ∂f/∂x_axis: on ``axis`` a face
    difference of kernel values at the cell edges (valid for every kind),
    the cell/point integrals elsewhere."""
    axis = common.canonical_axis(spec, axis)
    return _grid_gaussian(spec, params, X, y, grid_axes,
                          common.grad_grid_kvv(spec, params, grid_axes, axis, dense=False),
                          axis, full_cov)


@highest_precision
def p_v_u(spec: FreeSVGPSpec, params: Params, X: torch.Tensor, y: torch.Tensor,
          grid_axes: Sequence) -> Gaussian:
    """p(v | u = E_q[u]): mean Kvu Kuu⁻¹ m_u = R L_B⁻ᵀ c, dense cov
    Kvv − RRᵀ."""
    chol, _, LB, c, _ = _factored_state(spec, params, X, y)
    R = chol.whiten(_kvu(spec, params, grid_axes).T).T
    g = Gaussian(mean=tri_solve(LB, R.T).T @ c,
                 cov=common.grid_kvv(spec, params, grid_axes, dense=True) - R @ R.T)
    return common.shift_mean(g, common.grid_mean(spec, params, grid_axes))


@highest_precision
def posterior_grad(spec: FreeSVGPSpec, params: Params, X: torch.Tensor, y: torch.Tensor,
                   xstar: torch.Tensor, axis: int, full_cov: bool = False) -> Gaussian:
    """The posterior of ∂f/∂x_axis: Cov(f(z_j), ∂f(x*)) = k′_axis ·
    Π_{d≠axis} k_d, the axis factor of the Hadamard Gram swapped for the
    kernel's derivative. Needs a once-differentiable kind on ``axis``
    (Matérn-1/2 raises ValueError)."""
    axis = common.canonical_axis(spec, axis)
    kernels.require_differentiable(spec.kinds[axis])
    chol, _, LB, c, _ = _factored_state(spec, params, X, y)
    z = params["z"]
    kdu = None
    for d, kind in enumerate(spec.kinds):
        p = common.axis_params(params, d)
        fn = kernels.dgram_1d if d == axis else kernels.gram_1d
        g = fn(kind, xstar[:, d], z[:, d], p["variance"], p["lengthscale"])
        kdu = g if kdu is None else kdu * g
    return common.conditional(chol.whiten(kdu.T), LB, c,
                              lambda: common.grad_gram_full(spec, params, xstar, xstar, axis),
                              lambda: common.grad_kdiag(spec, params, xstar, axis), full_cov)


class FreeSVGP(common.HeldDataModule):
    """The free-point collapsed GP as a module (:class:`common.HeldDataModule`),
    the points ``z`` one of its parameters: ``forward()`` is the loss; the
    heads condition on the held data."""

    def forward(self) -> torch.Tensor:
        return loss(self.spec, self.params(), self.X, self.y)

    def posterior(self, xstar: torch.Tensor, full_cov: bool = False,
                  predictive: bool = False) -> Gaussian:
        return posterior(self.spec, self.params(), self.X, self.y, xstar, full_cov=full_cov,
                         predictive=predictive)

    def q_v(self, grid_axes: Sequence, full_cov: bool = False) -> Gaussian:
        return q_v(self.spec, self.params(), self.X, self.y, grid_axes, full_cov)
