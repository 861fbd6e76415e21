"""Sum-of-separable-kernels sparse GP, f(x) = Σ_q f_q(x), with the collapsed
ELBO — port of ``vggp_tpu/models/sum.py``. Each component q is a separable
product over all the input axes with its own kinds and inducing features:

    k(x, x′) = Σ_q Π_i k_qi(x_i, x′_i),  Kuu = blockdiag(Kuu_1, …, Kuu_Q),
    Kuf = vstack(KhatriRao_q(x), …),      k_ff = Σ_q Π_i diag K_qi,

so the collapsed bound keeps the factored O(n·m²) form with m = Σ_q m_q.
Its uses: a multi-scale field (a long-lengthscale component on a coarse
grid and a short one on a fine grid), and the full LMC multi-output model
(components with a coregion axis, cov = Σ_q B_q ⊗ K_q).

Every component whitens through its dense Kuu factors (``axis_chol_kuu``)
and trains by autograd through them: the Matérn-1/2 cells reach
``cell_kuf`` through ``CellKufOp``, one launch per axis of each component.
A component's spec is an ``SGPRSpec`` (its jitter and factor method apply to
its own blocks); the noise and the mean, scalar or per output, are the sum
spec's. With free lengthscales on every component the split of the signal
between the scales is not identifiable: freeze one through
``train.fit(trainable=…)``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

import torch

from vggp_tpu_torch import config, kernels
from vggp_tpu_torch.config import highest_precision
from vggp_tpu_torch.models import common
from vggp_tpu_torch.models.common import Gaussian
from vggp_tpu_torch.models.sgpr import SGPRSpec
from vggp_tpu_torch.ops.chol import safe_cholesky, tri_solve
from vggp_tpu_torch.ops.kron import kron_dense, kron_diag

Params = Dict


@dataclass(frozen=True)
class SumSGPRSpec:
    """Static config: one ``SGPRSpec`` per component. Every component spans
    the same input axes, and a coregion axis sits at the same position in
    each (the output-index column is shared)."""

    components: Tuple[SGPRSpec, ...]
    per_output_noise: bool = False
    learn_mean: bool = False

    def __post_init__(self):
        if len(self.components) < 1 or len({c.ndim for c in self.components}) != 1:
            raise ValueError("components must be non-empty and share ndim")
        cos = {c.kinds.index(kernels.COREGION_KIND) if kernels.COREGION_KIND in c.kinds
               else None for c in self.components}
        if len(cos) != 1:
            raise ValueError(
                "the coregion axis must sit at the same position in every "
                f"component (got positions {sorted(map(str, cos))})")

    @property
    def ndim(self) -> int:
        return self.components[0].ndim

    @property
    def kinds(self) -> Tuple[str, ...]:
        """The first component's kinds: where the coregion axis sits is what
        ``common.obs_noise`` and ``common.mean_fn`` read."""
        return self.components[0].kinds

    @property
    def num_inducing(self) -> int:
        return sum(c.num_inducing for c in self.components)

    def _n_outputs(self) -> int:
        c0 = self.components[0]
        return c0.features[c0.kinds.index(kernels.COREGION_KIND)].n_outputs

    def init_params(self, dtype=torch.float32, device=None) -> Params:
        """Each component's axes as its ``SGPRSpec`` inits them, noise 0.1
        and the mean 0 when it is learned, each per output where asked, on
        ``cuda`` unless ``device`` is given."""
        device = config.resolve_device(device)
        comps = tuple({"axes": c.init_params(dtype, device)["axes"]} for c in self.components)
        noise = torch.full((self._n_outputs(),) if self.per_output_noise else (), 0.1,
                           dtype=dtype, device=device)
        out = {"components": comps, "noise": noise}
        if self.learn_mean:
            out["mean"] = torch.zeros((self._n_outputs(),) if kernels.COREGION_KIND in self.kinds
                                      else (), dtype=dtype, device=device)
        return out


def _comp_params(params: Params, q: int) -> Params:
    """Component q's parameters in the layout the per-axis helpers read."""
    return {"axes": params["components"][q]["axes"], "noise": params["noise"]}


def _comp_whitened(spec: SumSGPRSpec, params: Params, X: torch.Tensor):
    """(chols_q, a_q) per component: a_q = KhatriRao_i(F_qi⁻¹ Kuf_qi)."""
    chols, rows = [], []
    for q, c in enumerate(spec.components):
        cp = _comp_params(params, q)
        ch = common.axis_chol_kuu(c, cp)
        chols.append(ch)
        rows.append(common.khatri_rao_all(common.axis_whitened_kuf(c, cp, ch, X)))
    return tuple(chols), rows


def _factored_state(spec: SumSGPRSpec, params: Params, X: torch.Tensor, y: torch.Tensor):
    """(chols, A, L_B, c, y − m(X)): the stacked components' factored form,
    its n-term sums accumulated in float64 (``common.gram_accumulated``)."""
    if X.dim() == 1:
        X = X[:, None]
    y = y.reshape(-1) - common.mean_fn(spec, params, X)
    sigma = torch.sqrt(common.obs_noise(spec, params, X))
    chols, rows = _comp_whitened(spec, params, X)
    A = torch.cat(rows, dim=0) / sigma               # (Σm_q, n)
    B, Ay = common.gram_accumulated(A, y / sigma)
    LB = safe_cholesky(B, 1e-12)
    return chols, A, LB, tri_solve(LB, Ay), y


@highest_precision
def precompute(spec: SumSGPRSpec, params: Params, X: torch.Tensor, y: torch.Tensor):
    """The training-set state (chols, A, L_B, c) of the ``*_from_state``
    heads; rebuild it after any parameter update."""
    return _factored_state(spec, params, X, y)[:4]


def kdiag(spec: SumSGPRSpec, params: Params, X: torch.Tensor) -> torch.Tensor:
    """diag K_ff = Σ_q Π_i diag K_qi."""
    if X.dim() == 1:
        X = X[:, None]
    out = None
    for q, c in enumerate(spec.components):
        d = common.kdiag(c, _comp_params(params, q), X)
        out = d if out is None else out + d
    return out


def gram_full(spec: SumSGPRSpec, params: Params, x1: torch.Tensor,
              x2: torch.Tensor) -> torch.Tensor:
    """Dense Σ_q Π_i K_qi(x1, x2)."""
    out = None
    for q, c in enumerate(spec.components):
        g = common.gram_full(c, _comp_params(params, q), x1, x2)
        out = g if out is None else out + g
    return out


@highest_precision
def elbo(spec: SumSGPRSpec, params: Params, X: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The collapsed (Titsias) bound over the stacked components, the form
    of ``common.collapsed_elbo`` (per-output noise included)."""
    if X.dim() == 1:
        X = X[:, None]
    _, A, LB, c, y = _factored_state(spec, params, X, y)
    noise = common.obs_noise(spec, params, X).expand(y.shape[0])
    kff = kdiag(spec, params, X)
    bound = -0.5 * torch.sum(torch.log(2.0 * torch.pi * noise))
    bound = bound - torch.sum(torch.log(torch.diagonal(LB)))
    bound = bound - 0.5 * torch.sum(y * y / noise)
    bound = bound + 0.5 * torch.sum(c * c)
    return bound - 0.5 * common.nonneg(torch.sum(kff / noise) - torch.sum(A * A))


def loss(spec: SumSGPRSpec, params: Params, X: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return -elbo(spec, params, X, y)


def _stacked(spec: SumSGPRSpec, params: Params, chols, xstar: torch.Tensor,
             blocks_fn=common.axis_whitened_kuf) -> torch.Tensor:
    """(Σm_q, n*): each component's Khatri–Rao of ``blocks_fn``'s whitened
    per-axis blocks at ``xstar``, stacked."""
    return torch.cat([common.khatri_rao_all(blocks_fn(comp, _comp_params(params, q), chols[q],
                                                      xstar))
                      for q, comp in enumerate(spec.components)], dim=0)


@highest_precision
def posterior_from_state(spec: SumSGPRSpec, params: Params, state, xstar: torch.Tensor,
                         full_cov: bool = False, predictive: bool = False) -> Gaussian:
    """q(f*) from a :func:`precompute` state."""
    if xstar.dim() == 1:
        xstar = xstar[:, None]
    chols, _, LB, c = state[:4]
    noise = common.obs_noise(spec, params, xstar) if predictive else 0.0
    g = common.conditional(_stacked(spec, params, chols, xstar), LB, c,
                           lambda: gram_full(spec, params, xstar, xstar),
                           lambda: kdiag(spec, params, xstar), full_cov, noise)
    return common.shift_mean(g, common.mean_fn(spec, params, xstar))


@highest_precision
def posterior(spec: SumSGPRSpec, params: Params, X: torch.Tensor, y: torch.Tensor,
              xstar: torch.Tensor, full_cov: bool = False, predictive: bool = False) -> Gaussian:
    return posterior_from_state(spec, params, precompute(spec, params, X, y), xstar,
                                full_cov=full_cov, predictive=predictive)


def posterior_predictive(spec, params, X, y, xstar, full_cov: bool = False) -> Gaussian:
    return posterior(spec, params, X, y, xstar, full_cov=full_cov, predictive=True)


def prior(spec: SumSGPRSpec, params: Params, xstar: torch.Tensor) -> Gaussian:
    """Prior N(m, Σ_q K_q) at ``xstar``."""
    cov = gram_full(spec, params, xstar, xstar)
    mean = torch.zeros(cov.shape[0], dtype=cov.dtype, device=cov.device)
    return Gaussian(mean=mean + common.mean_fn(spec, params, xstar), cov=cov)


@highest_precision
def q_u(spec: SumSGPRSpec, params: Params, X: torch.Tensor, y: torch.Tensor) -> Gaussian:
    """The optimal q(u) over the stacked u = (u¹, …, u^Q)."""
    chols, _, LB, c = precompute(spec, params, X, y)
    L = torch.block_diag(*[kron_dense([f.F for f in ch]) for ch in chols])
    half = tri_solve(LB, L.T).T
    return Gaussian(mean=half @ c, cov=half @ half.T)


def _grid_r_rows(spec: SumSGPRSpec, params: Params, chols, kvu_fn) -> torch.Tensor:
    """R = [⊗(Kvu_1i F_1i⁻ᵀ), …, ⊗(Kvu_Qi F_Qi⁻ᵀ)], (g, Σm_q): the whitened
    grid/inducing cross block of the stacked components; ``kvu_fn(comp, cp)``
    gives a component's per-axis Kvu blocks (cell integrals, or the face
    differences of the gradient heads)."""
    rows = []
    for q, comp in enumerate(spec.components):
        kvu = kvu_fn(comp, _comp_params(params, q))
        rows.append(kron_dense([chols[q][i].whiten(kvu[i].T).T for i in range(comp.ndim)]))
    return torch.cat(rows, dim=1)


def _grid_gaussian(spec: SumSGPRSpec, params: Params, state, kvu_fn, kvv_fn,
                   full_cov: bool) -> Gaussian:
    """A grid-product posterior of the summed field: R from
    :func:`_grid_r_rows`, Kvv = Σ_q of ``kvv_fn(comp, cp)``'s per-axis
    Kronecker blocks, mean TC and cov Kvv − RRᵀ + TTᵀ (T = R L_B⁻ᵀ)."""
    chols, _, LB, c = state[:4]
    R = _grid_r_rows(spec, params, chols, kvu_fn)
    T = tri_solve(LB, R.T).T
    kvv = None
    for q, comp in enumerate(spec.components):
        blocks = kvv_fn(comp, _comp_params(params, q))
        kq = kron_dense(blocks) if full_cov else kron_diag([torch.diagonal(b) for b in blocks])
        kvv = kq if kvv is None else kvv + kq
    if full_cov:
        return Gaussian(mean=T @ c, cov=kvv - R @ R.T + T @ T.T)
    var = kvv - torch.sum(R * R, dim=1) + torch.sum(T * T, dim=1)
    return Gaussian(mean=T @ c, var=common.floor_var(var, kvv))


@highest_precision
def q_v_from_state(spec: SumSGPRSpec, params: Params, state, grid_axes: Sequence,
                   full_cov: bool = False) -> Gaussian:
    """The gridded q(v), v = ∫_cell Σ_q f_q: Kvu = [Kvu_1, …, Kvu_Q] and
    Kvv = Σ_q ⊗_i Kvv_qi, Cholesky-propagated as ``sgpr.q_v``."""
    g = _grid_gaussian(spec, params, state,
                       lambda comp, cp: common.grid_kvu(comp, cp, grid_axes),
                       lambda comp, cp: common.grid_kvv(comp, cp, grid_axes, dense=False),
                       full_cov)
    return common.shift_mean(g, common.grid_mean(spec, params, grid_axes))


@highest_precision
def q_v(spec: SumSGPRSpec, params: Params, X: torch.Tensor, y: torch.Tensor,
        grid_axes: Sequence, full_cov: bool = False) -> Gaussian:
    return q_v_from_state(spec, params, precompute(spec, params, X, y), grid_axes, full_cov)


@highest_precision
def p_v_u(spec: SumSGPRSpec, params: Params, X: torch.Tensor, y: torch.Tensor,
          grid_axes: Sequence) -> Gaussian:
    """p(v | u = E_q[u]) of the stacked components: mean R L_B⁻ᵀ c, dense
    cov Kvv − RRᵀ with Kvv = Σ_q ⊗_i Kvv_qi."""
    chols, _, LB, c = precompute(spec, params, X, y)
    R = _grid_r_rows(spec, params, chols, lambda comp, cp: common.grid_kvu(comp, cp, grid_axes))
    kvv = sum(kron_dense(common.grid_kvv(comp, _comp_params(params, q), grid_axes, dense=False))
              for q, comp in enumerate(spec.components))
    g = Gaussian(mean=tri_solve(LB, R.T).T @ c, cov=kvv - R @ R.T)
    return common.shift_mean(g, common.grid_mean(spec, params, grid_axes))


@highest_precision
def q_dv(spec: SumSGPRSpec, params: Params, X: torch.Tensor, y: torch.Tensor,
         grid_axes: Sequence, axis: int, full_cov: bool = False) -> Gaussian:
    """The gridded-gradient posterior q(∫_cell ∂f/∂x_axis) of the summed
    field: per-component face-difference blocks stacked, Kvv the sum of the
    components' gradient Kvv."""
    axis = common.canonical_axis(spec.components[0], axis)
    return _grid_gaussian(
        spec, params, precompute(spec, params, X, y),
        lambda comp, cp: common.grad_grid_kvu(comp, cp, grid_axes, axis),
        lambda comp, cp: common.grad_grid_kvv(comp, cp, grid_axes, axis, dense=False), full_cov)


@highest_precision
def posterior_grad(spec: SumSGPRSpec, params: Params, X: torch.Tensor, y: torch.Tensor,
                   xstar: torch.Tensor, axis: int, full_cov: bool = False) -> Gaussian:
    """The pointwise-gradient posterior ∂f/∂x_axis of the summed field: the
    whitened ∂Kuf rows of each component stacked, the prior Σ_q of the
    components' gradient marginals. Needs a once-differentiable kind on
    ``axis`` in every component (Matérn-1/2 raises ValueError)."""
    if xstar.dim() == 1:
        xstar = xstar[:, None]
    axis = common.canonical_axis(spec.components[0], axis)
    chols, _, LB, c = precompute(spec, params, X, y)
    w = _stacked(spec, params, chols, xstar,
                 lambda s, p, ch, x: common.axis_whitened_dkuf(s, p, ch, x, axis))
    comps = list(enumerate(spec.components))
    return common.conditional(
        w, LB, c,
        lambda: sum(common.grad_gram_full(comp, _comp_params(params, q), xstar, xstar, axis)
                    for q, comp in comps),
        lambda: sum(common.grad_kdiag(comp, _comp_params(params, q), xstar, axis)
                    for q, comp in comps), full_cov)


def component_posterior(spec: SumSGPRSpec, params: Params, state, xstar: torch.Tensor, q: int,
                        full_cov: bool = False) -> Gaussian:
    """q(f_q*), the posterior of component ``q`` alone at ``xstar`` (the
    decomposition of the signal by scale or latent): its cross-covariance
    with the stacked u is nonzero only on the q-th block."""
    if xstar.dim() == 1:
        xstar = xstar[:, None]
    chols, _, LB, c = state[:4]
    comp, cp = spec.components[q], _comp_params(params, q)
    w_q = common.khatri_rao_all(common.axis_whitened_kuf(comp, cp, chols[q], xstar))
    sizes = [cc.num_inducing for cc in spec.components]
    lo = sum(sizes[:q])
    w = torch.zeros((sum(sizes), xstar.shape[0]), dtype=w_q.dtype, device=w_q.device)
    w = torch.cat([w[:lo], w_q, w[lo + sizes[q]:]], dim=0)
    return common.conditional(w, LB, c, lambda: common.gram_full(comp, cp, xstar, xstar),
                              lambda: common.kdiag(comp, cp, xstar), full_cov)


class SumSGPR(common.HeldDataModule):
    """The sum-of-kernels collapsed GP as a module
    (:class:`common.HeldDataModule`; the raw parameters under
    ``components``): ``forward()`` is the loss; the heads condition on the
    held data."""

    def forward(self) -> torch.Tensor:
        return loss(self.spec, self.params(), self.X, self.y)

    def posterior(self, xstar: torch.Tensor, full_cov: bool = False,
                  predictive: bool = False) -> Gaussian:
        return posterior(self.spec, self.params(), self.X, self.y, xstar, full_cov=full_cov,
                         predictive=predictive)

    def precompute(self):
        return precompute(self.spec, self.params(), self.X, self.y)

    def component_posterior(self, xstar: torch.Tensor, q: int, full_cov: bool = False,
                            state=None) -> Gaussian:
        return component_posterior(self.spec, self.params(), state or self.precompute(), xstar,
                                   q, full_cov)
