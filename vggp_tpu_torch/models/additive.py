"""Additive-structure sparse GP, f(x) = Σ_d f_d(x_d), with the collapsed
ELBO — port of ``vggp_tpu/models/additive.py``. Each independent 1-D
component f_d has its own inducing features u^(d), so jointly

    Kuu = blockdiag(Kuu_1, …, Kuu_D),  Kuf = vstack(Kuf_1(x_1), …),
    k_ff = Σ_d σ_d²,

and the collapsed bound, the posterior and the gridded heads reuse the
factored pipeline of ``models.common`` with a concatenation where the
Kronecker models take a Khatri–Rao product. Fixed bases take the
scalar-tangent whitening of training (the Matérn-1/2 cells: one
``cell_kuf_with_dl``, or at large batch one fused-kernel launch, per axis).

The 2-D gridded head integrates the sum over 2-D cells:
v_ij = ∫∫_cell f = δ₂V¹_i + δ₁V²_j, V^d the per-axis cell integrals of f_d,
which gives a Kronecker-sum Kvv.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

import torch

from vggp_tpu_torch import config, kernels
from vggp_tpu_torch.config import highest_precision
from vggp_tpu_torch.models import common
from vggp_tpu_torch.models.common import Gaussian
from vggp_tpu_torch.ops.chol import tri_solve

Params = Dict

_UNIFORM = ("additive gridded heads assume uniform grid axes (constant δ per axis); "
            "use per-axis uniform meshes")


def _concat(blocks) -> torch.Tensor:
    """The additive combiner: a block-diagonal Kuu stacks the whitened blocks."""
    return torch.cat(tuple(blocks), dim=0)


@dataclass(frozen=True)
class AdditiveSGPRSpec:
    """Static config: one kernel kind and feature family per component."""

    kinds: Tuple[str, ...]
    features: Tuple
    jitter: float = 1e-6
    factor_method: str = "chol"

    @property
    def ndim(self) -> int:
        return len(self.kinds)

    @property
    def num_inducing(self) -> int:
        return sum(f.m for f in self.features)

    def init_params(self, dtype=torch.float32, device=None) -> Params:
        """σ² = ℓ = 1 per component (and the feature's own), noise 0.1, on
        ``cuda`` unless ``device`` is given."""
        return common.init_tree(self.kinds, self.features, False, False, dtype,
                                config.resolve_device(device))


def _kdiag(spec, params: Params, X: torch.Tensor) -> torch.Tensor:
    """diag K_ff = Σ_d σ_d², the sum of the component variances."""
    noise = params["noise"]
    v = torch.zeros((X.shape[0],), dtype=noise.dtype, device=noise.device)
    for i in range(spec.ndim):
        v = v + common.axis_params(params, i)["variance"]
    return v


def _factored_state(spec: AdditiveSGPRSpec, params: Params, X: torch.Tensor, y: torch.Tensor):
    return common.factored_state(spec, params, X, y, combine=_concat)


@highest_precision
def elbo(spec: AdditiveSGPRSpec, params: Params, X: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The collapsed bound, as ``sgpr.elbo`` with the blocks stacked."""
    return common.collapsed_elbo(spec, params, X, y, combine=_concat, kdiag_fn=_kdiag)


def loss(spec: AdditiveSGPRSpec, params: Params, X: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return -elbo(spec, params, X, y)


def _gram_add(spec, params: Params, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Dense Σ_d k_d(x1_d, x2_d)."""
    if x1.dim() == 1:
        x1 = x1[:, None]
    if x2.dim() == 1:
        x2 = x2[:, None]
    out = None
    for i, kind in enumerate(spec.kinds):
        p = common.axis_params(params, i)
        g = kernels.gram_1d(kind, x1[:, i], x2[:, i], p["variance"], p["lengthscale"])
        out = g if out is None else out + g
    return out


@highest_precision
def posterior(spec: AdditiveSGPRSpec, params: Params, X: torch.Tensor, y: torch.Tensor,
              xstar: torch.Tensor, full_cov: bool = False, predictive: bool = False) -> Gaussian:
    """q(f*) at ``xstar``."""
    if xstar.dim() == 1:
        xstar = xstar[:, None]
    return common.collapsed_posterior(spec, params, _factored_state(spec, params, X, y), xstar,
                                      full_cov=full_cov, predictive=predictive,
                                      kdiag_fn=_kdiag, gram_fn=_gram_add, combine=_concat)


def posterior_predictive(spec, params, X, y, xstar, full_cov: bool = False) -> Gaussian:
    return posterior(spec, params, X, y, xstar, full_cov=full_cov, predictive=True)


def prior(spec: AdditiveSGPRSpec, params: Params, xstar: torch.Tensor) -> Gaussian:
    """Prior N(0, Σ_d k_d) at ``xstar``."""
    cov = _gram_add(spec, params, xstar, xstar)
    return Gaussian(mean=torch.zeros(cov.shape[0], dtype=cov.dtype, device=cov.device), cov=cov)


@highest_precision
def q_u(spec: AdditiveSGPRSpec, params: Params, X: torch.Tensor, y: torch.Tensor) -> Gaussian:
    """The optimal q(u) over the stacked u = (u¹, …, u^D):
    N(L L_B⁻ᵀ c, L B⁻¹ Lᵀ) with L = blockdiag(F_d)."""
    chols, _, LB, c, _ = _factored_state(spec, params, X, y)
    half = tri_solve(LB, torch.block_diag(*[f.F for f in chols]).T).T    # L L_B⁻ᵀ
    return Gaussian(mean=half @ c, cov=half @ half.T)


def _grid_R_kvv(spec, params: Params, chols, grid_axes):
    """The whitened Kvu rows R, (G1·G2, m1 + m2) in the row-major (i, j)
    order, [δ₂·r1_i, δ₁·r2_j]; and the per-axis scaled grid covariances."""
    g1, g2 = grid_axes
    if not (g1.uniform and g2.uniform):
        raise ValueError(_UNIFORM)
    d1, d2 = g1.delta, g2.delta
    kvu = common.grid_kvu(spec, params, grid_axes)
    r1 = chols[0].whiten(kvu[0].T).T * d2            # (G1, m1)
    r2 = chols[1].whiten(kvu[1].T).T * d1            # (G2, m2)
    G1, G2 = r1.shape[0], r2.shape[0]
    R = torch.cat([torch.repeat_interleave(r1, G2, dim=0), r2.repeat(G1, 1)], dim=1)
    kvv1 = g1.Kuu(spec.kinds[0], common.axis_params(params, 0)) * d2 * d2
    kvv2 = g2.Kuu(spec.kinds[1], common.axis_params(params, 1)) * d1 * d1
    return R, kvv1, kvv2, G1, G2


def _kvv_dense(kvv1, kvv2, G1, G2) -> torch.Tensor:
    """Cov[v_ij, v_kl] = d2²Kvv1[i, k] + d1²Kvv2[j, l]: the cross-axis
    blocks are all-ones (each component is constant across the other
    axis's cells), not the identity."""
    ones1 = torch.ones((G1, G1), dtype=kvv1.dtype, device=kvv1.device)
    ones2 = torch.ones((G2, G2), dtype=kvv2.dtype, device=kvv2.device)
    return torch.kron(kvv1, ones2) + torch.kron(ones1, kvv2)


def _two_components(spec, what: str) -> None:
    if spec.ndim != 2:
        raise ValueError(f"additive {what} implemented for 2 components")


@highest_precision
def q_v(spec: AdditiveSGPRSpec, params: Params, X: torch.Tensor, y: torch.Tensor,
        grid_axes: Sequence, full_cov: bool = False) -> Gaussian:
    """The gridded posterior over the 2-D cell integrals of the additive
    field: Kvu = [δ₂·Kvu₁ ⊗ 1, 1 ⊗ δ₁·Kvu₂], Kvv = δ₂²Kvv₁ ⊕ δ₁²Kvv₂ (a
    Kronecker sum). Two components only."""
    _two_components(spec, "q_v")
    chols, _, LB, c, _ = _factored_state(spec, params, X, y)
    R, kvv1, kvv2, G1, G2 = _grid_R_kvv(spec, params, chols, grid_axes)
    T = tri_solve(LB, R.T).T
    mean = T @ c
    if full_cov:
        return Gaussian(mean=mean, cov=_kvv_dense(kvv1, kvv2, G1, G2) - R @ R.T + T @ T.T)
    kvv_diag = (torch.repeat_interleave(torch.diagonal(kvv1), G2)
                + torch.diagonal(kvv2).repeat(G1))
    var = kvv_diag - torch.sum(R * R, dim=1) + torch.sum(T * T, dim=1)
    return Gaussian(mean=mean, var=common.floor_var(var, kvv_diag))


@highest_precision
def posterior_grad(spec: AdditiveSGPRSpec, params: Params, X: torch.Tensor, y: torch.Tensor,
                   xstar: torch.Tensor, axis: int, full_cov: bool = False) -> Gaussian:
    """The posterior of ∂f/∂x_axis: only component ``axis`` varies along
    x_axis, so the cross block is [0, …, F_axis⁻¹∂Kuf_axis, …, 0] and the
    prior marginal −k_axis″(0). Needs a once-differentiable kind on
    ``axis`` (Matérn-1/2 raises ValueError)."""
    axis = common.canonical_axis(spec, axis)
    kernels.require_differentiable(spec.kinds[axis])
    chols, A, LB, c, _ = _factored_state(spec, params, X, y)
    if xstar.dim() == 1:
        xstar = xstar[:, None]
    n = xstar.shape[0]
    blocks = []
    for i, (kind, feat) in enumerate(zip(spec.kinds, spec.features)):
        if i == axis:
            p = common.axis_params(params, i)
            blocks.append(chols[i].whiten(feat.dKuf_dx(kind, p, xstar[:, i])))
        else:
            blocks.append(torch.zeros((feat.m, n), dtype=A.dtype, device=A.device))
    w = _concat(blocks)
    tmp = tri_solve(LB, w)
    mean = tmp.T @ c
    p_ax = common.axis_params(params, axis)
    if full_cov:
        kss = kernels.grad_gram_1d(spec.kinds[axis], xstar[:, axis], xstar[:, axis],
                                   p_ax["variance"], p_ax["lengthscale"])
        return Gaussian(mean=mean, cov=kss - w.T @ w + tmp.T @ tmp)
    kss = kernels.grad_variance(spec.kinds[axis], p_ax["variance"], p_ax["lengthscale"]) * \
        torch.ones((n,), dtype=A.dtype, device=A.device)
    var = kss - torch.sum(w * w, dim=0) + torch.sum(tmp * tmp, dim=0)
    return Gaussian(mean=mean, var=common.floor_var(var, kss))


@highest_precision
def q_dv(spec: AdditiveSGPRSpec, params: Params, X: torch.Tensor, y: torch.Tensor,
         grid_axes: Sequence, axis: int, full_cov: bool = False) -> Gaussian:
    """The gridded-gradient posterior of the 2-D additive field along
    ``axis``: v′_ij = δ_other·(f_axis(β) − f_axis(α)), the other component
    constant along ``axis`` and gone; exact for every kind."""
    _two_components(spec, "q_dv")
    axis = common.canonical_axis(spec, axis)
    chols, A, LB, c, _ = _factored_state(spec, params, X, y)
    other = 1 - axis
    g_ax = grid_axes[axis]
    if not (g_ax.uniform and grid_axes[other].uniform):
        raise ValueError(_UNIFORM)
    d_other = grid_axes[other].delta
    kind, feat = spec.kinds[axis], spec.features[axis]
    p = common.axis_params(params, axis)
    kue = feat.Kuf(kind, p, g_ax.mesh_j(p))                  # (m_ax, G_ax + 1)
    r_ax = chols[axis].whiten((kue[:, 1:] - kue[:, :-1]) * d_other).T   # (G_ax, m_ax)
    G_ax, G_oth = g_ax.m, grid_axes[other].m
    zeros = torch.zeros((G_ax * G_oth, spec.features[other].m), dtype=A.dtype, device=A.device)
    if axis == 0:
        R = torch.cat([torch.repeat_interleave(r_ax, G_oth, dim=0), zeros], dim=1)
    else:
        R = torch.cat([zeros, r_ax.repeat(G_oth, 1)], dim=1)
    T = tri_solve(LB, R.T).T
    mean = T @ c
    kvv_ax = common._face_diff_gram(kind, p, g_ax) * (d_other * d_other)
    if full_cov:
        ones = torch.ones((G_oth, G_oth), dtype=A.dtype, device=A.device)
        kvv = torch.kron(kvv_ax, ones) if axis == 0 else torch.kron(ones, kvv_ax)
        return Gaussian(mean=mean, cov=kvv - R @ R.T + T @ T.T)
    dax = torch.diagonal(kvv_ax)
    kvv_diag = torch.repeat_interleave(dax, G_oth) if axis == 0 else dax.repeat(G_oth)
    var = kvv_diag - torch.sum(R * R, dim=1) + torch.sum(T * T, dim=1)
    return Gaussian(mean=mean, var=common.floor_var(var, kvv_diag))


@highest_precision
def p_v_u(spec: AdditiveSGPRSpec, params: Params, X: torch.Tensor, y: torch.Tensor,
          grid_axes: Sequence) -> Gaussian:
    """p(v | u = E_q[u]) of the 2-D gridded head: mean R L_B⁻ᵀ c, dense
    cov Kvv − RRᵀ."""
    _two_components(spec, "p_v_u")
    chols, _, LB, c, _ = _factored_state(spec, params, X, y)
    R, kvv1, kvv2, G1, G2 = _grid_R_kvv(spec, params, chols, grid_axes)
    g = Gaussian(mean=tri_solve(LB, R.T).T @ c, cov=_kvv_dense(kvv1, kvv2, G1, G2) - R @ R.T)
    return common.shift_mean(g, common.grid_mean(spec, params, grid_axes))


class AdditiveSGPR(common.HeldDataModule):
    """The additive collapsed GP as a module (:class:`common.HeldDataModule`):
    ``forward()`` is the loss; the heads condition on the held data."""

    def forward(self) -> torch.Tensor:
        return loss(self.spec, self.params(), self.X, self.y)

    def posterior(self, xstar: torch.Tensor, full_cov: bool = False,
                  predictive: bool = False) -> Gaussian:
        return posterior(self.spec, self.params(), self.X, self.y, xstar, full_cov=full_cov,
                         predictive=predictive)

    def q_v(self, grid_axes: Sequence, full_cov: bool = False) -> Gaussian:
        return q_v(self.spec, self.params(), self.X, self.y, grid_axes, full_cov)
