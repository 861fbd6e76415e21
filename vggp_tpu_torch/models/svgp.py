"""Whitened, minibatchable SVGP — port of ``vggp_tpu/models/svgp.py``:
training (the ELBO, and ``elbo_muS`` over an explicit q(w) = N(μ, S)), and
the serving heads (posteriors with full covariance, q(u), p(v | u), the
gridded product q(v), its gradient field q(∂v), the pointwise-gradient
posteriors and the warm ``precompute`` state), with an optional learned
constant mean.

Two variational families over the whitened u = F w, q(w) = N(μ, S):

- ``variational="full"`` (the default, any ndim, small m): a dense
  lower-triangular factor of S and μ of shape (m,); the per-axis whitened
  features a_i = F_i⁻¹ Kuf_i are joined into the (m, n) Khatri–Rao block;
- ``variational="kron"`` (ndim ≥ 2, huge m): S = S₁ ⊗ S₂ ⊗ …, every ELBO
  term from per-axis (m_i, m_i) and (m_i, n) matrices, the m = Π m_i
  inducing grid never materialized. ``mu`` has shape (m₁, m₂, …);
  flattening follows the ``numpy.kron`` row-major order, as in the JAX
  package. Only the heads whose output is dense by nature (``full_cov=True``,
  ``q_u``, ``p_v_u``) build m- or grid-sized matrices.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

import torch
from torch import nn

from vggp_tpu_torch import config, likelihoods
from vggp_tpu_torch.config import highest_precision, matmul_precision
from vggp_tpu_torch.models import common
from vggp_tpu_torch.models.common import Gaussian
from vggp_tpu_torch.ops.cell_kuf import SHAPE_LAUNCHES
from vggp_tpu_torch.ops.kron import kron_dense, kron_diag
from vggp_tpu_torch.tracing import span, traced

Params = Dict


def chol_from_raw(raw: torch.Tensor) -> torch.Tensor:
    """Unconstrained (m, m) → lower-triangular with positive (softplus) diagonal."""
    d = torch.diagonal(raw)
    return torch.tril(raw, -1) + torch.diag(torch.logaddexp(d, torch.zeros_like(d)))


def raw_from_chol(L: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`chol_from_raw` (for initialization)."""
    d = torch.diagonal(L)
    return torch.tril(L, -1) + torch.diag(torch.log(torch.expm1(d)))


@dataclass(frozen=True)
class SVGPSpec:
    kinds: Tuple[str, ...]
    features: Tuple
    num_data: int                     # n_total, for minibatch scaling
    variational: str = "full"         # "full" | "kron"
    jitter: float = 1e-6
    factor_method: str = "chol"       # Kuu factorization: "chol" | "eigh"
    likelihood: str = "gaussian"      # see vggp_tpu_torch.likelihoods
    likelihood_opts: Tuple[Tuple[str, float], ...] = ()  # static, e.g. (("df", 4.0),)
    per_output_noise: bool = False    # a noise level per output (needs a coregion axis)
    learn_mean: bool = False          # a learned constant mean; per output with a coregion axis

    def __post_init__(self):
        if self.variational not in ("full", "kron"):
            raise ValueError(self.variational)
        if self.variational == "kron" and len(self.features) < 2:
            raise ValueError("kron variational family requires ndim >= 2")
        likelihoods.check_likelihood(self.likelihood)

    @property
    def ndim(self) -> int:
        return len(self.kinds)

    @property
    def axis_m(self) -> Tuple[int, ...]:
        return tuple(f.m for f in self.features)

    @property
    def num_inducing(self) -> int:
        return math.prod(self.axis_m)

    def init_params(self, dtype=torch.float32, device=None) -> Params:
        """Initial constrained parameters (:func:`common.init_tree`: the
        axes, the noise and the mean when it is learned, each per output
        where asked), μ = 0 and S = I (S_i = I for the Kronecker family).
        Runs on ``cuda`` unless ``device`` is given."""
        device = config.resolve_device(device)

        def eye_raw(m):
            return raw_from_chol(torch.eye(m, dtype=dtype, device=device))

        out = common.init_tree(self.kinds, self.features, self.per_output_noise,
                               self.learn_mean, dtype, device)
        if self.variational == "full":
            q = {"mu": torch.zeros((self.num_inducing,), dtype=dtype, device=device),
                 "raw_L": eye_raw(self.num_inducing)}
        else:
            q = {"mu": torch.zeros(self.axis_m, dtype=dtype, device=device)}
            for i, mi in enumerate(self.axis_m):
                q[f"raw_L{i + 1}"] = eye_raw(mi)
        mean = out.pop("mean", None)      # the JAX tree's order: axes, noise, q, mean
        return {**out, "q": q, **({} if mean is None else {"mean": mean})}


def _whitened_blocks(spec: SVGPSpec, params: Params, x: torch.Tensor):
    """(per-axis Kuu factors or None, per-axis whitened blocks). Fixed bases
    take the scalar-tangent whitening (closed-form F⁻¹); otherwise the dense
    factors of :func:`common.axis_chol_kuu`, differentiated by autograd."""
    if common.scalar_whiten_eligible(spec, params):
        return None, common.axis_whitened_kuf_scalar(spec, params, x)
    chols = common.axis_chol_kuu(spec, params)
    return chols, common.axis_whitened_kuf(spec, params, chols, x)


_AXIS_LETTERS = "abcdefgh"


def _kron_chols(spec: SVGPSpec, q: Params) -> Tuple[torch.Tensor, ...]:
    return tuple(chol_from_raw(q[f"raw_L{i + 1}"]) for i in range(spec.ndim))


def _var_chols(spec: SVGPSpec, q: Params):
    """The variational factor(s): one (m, m) matrix for the full family, the
    per-axis tuple for the Kronecker one."""
    if spec.variational == "full":
        return chol_from_raw(q["raw_L"])
    return _kron_chols(spec, q)


def _cov_half(spec: SVGPSpec, Ls, blocks) -> torch.Tensor:
    """L_Sᵀ a at the points of the whitened ``blocks``, (m, n):
    Lᵀ·(Khatri–Rao of the blocks), or the Khatri–Rao of the L_iᵀ a_i."""
    if spec.variational == "full":
        return Ls.T @ common.khatri_rao_all(blocks)
    return common.khatri_rao_all(tuple(Ls[i].T @ blocks[i] for i in range(spec.ndim)))


def _kron_contract(mu: torch.Tensor, mats: Sequence[torch.Tensor], out: str = "n") -> torch.Tensor:
    """einsum of μ (m₁…m_d) against one matrix per axis.

    ``out="n"``: mats are (m_i, n) with columns aligned (q(f) means).
    ``out="grid"``: mats are (g_i, m_i), an outer grid (q(v) means),
    flattened row-major in the ``numpy.kron`` order.
    """
    d = len(mats)
    L = _AXIS_LETTERS[:d]
    if out == "n":
        sub = ",".join(f"{L[i]}n" for i in range(d))
        return torch.einsum(f"{L},{sub}->n", mu, *mats)
    G = _AXIS_LETTERS[d:2 * d].upper()
    sub = ",".join(f"{G[i]}{L[i]}" for i in range(d))
    return torch.einsum(f"{L},{sub}->{G}", mu, *mats).reshape(-1)


def _mean_cotangent_einsums(d: int):
    """einsum strings for the q(f)-mean backward at ndim = d."""
    L = _AXIS_LETTERS[:d]
    blocks_sub = [f"{L[i]}n" for i in range(d)]
    dmu = ",".join(["n"] + blocks_sub) + f"->{L}"
    das = []
    for j in range(d):
        ins = ",".join([L] + [blocks_sub[i] for i in range(d) if i != j])
        das.append(f"{ins}->{L[j]}n")
    return dmu, das


def _var_terms(Ls, blocks):
    ts, rs, vs = [], [], []
    for i, a in enumerate(blocks):
        t = Ls[i].T @ a                # (m_i, n)
        ts.append(t)
        rs.append(torch.sum(a * a, dim=0))
        vs.append(torch.sum(t * t, dim=0))
    var_red, var_add = rs[0], vs[0]
    for i in range(1, len(blocks)):
        var_red = var_red * rs[i]
        var_add = var_add * vs[i]
    return var_red, var_add, ts, rs, vs


def _moments_math(mu, Ls, blocks):
    return (_kron_contract(mu, blocks), *_var_terms(Ls, blocks))


def _gemm_axis(blocks) -> int:
    """The axis that :func:`_contract_forward` leaves to the products: the
    widest (the first of equals), so that the Khatri–Rao of the others
    covers the least product of widths."""
    ms = [b.shape[0] for b in blocks]
    return ms.index(max(ms))


def _khatri_rao_t(blocks) -> torch.Tensor:
    """(n, Π m_j) Khatri–Rao of the (m_j, n) ``blocks``, points leading (the
    transpose of ``common.khatri_rao_all``), the columns row-major over the
    blocks in order (μ's flattening)."""
    n = blocks[0].shape[1]
    out = blocks[0].T
    for b in blocks[1:]:
        out = (out[:, :, None] * b.T[:, None, :]).reshape(n, -1)
    return out


def _contract_forward(mu, blocks):
    """The q(f) mean at d ≥ 3 as one product: with g the widest axis, A its
    block, K = KR(other blocks) and μ̃ = μ as (m_g, Π others),
    P = μ̃·Kᵀ (m_g, n) and mean = Σ_a A ⊙ P. Returns (mean, P, Kᵀ)."""
    g = _gemm_axis(blocks)
    kt = _khatri_rao_t([b for i, b in enumerate(blocks) if i != g])
    p = mu.movedim(g, 0).reshape(mu.shape[g], -1) @ kt.T
    SHAPE_LAUNCHES["kron_contract", mu.numel(), kt.shape[0]] += 1
    return torch.sum(blocks[g] * p, dim=0), p, kt


def _contract_backward(mu, blocks, p, kt, gm):
    """(∂μ, the mean's part of each ∂a_i) of :func:`_contract_forward` at the
    mean's cotangent ``gm``: with G = A ⊙ gm, ∂μ̃ = G·K, ∂A = P ⊙ gm, and
    Y = Gᵀ·μ̃ (n, Π others) summed against the other blocks for each of them.
    Two more products of Π m_i·n FMAs, no intermediate above K's size."""
    g = _gemm_axis(blocks)
    others = [i for i in range(len(blocks)) if i != g]
    mu_g = mu.movedim(g, 0).reshape(mu.shape[g], -1)
    ag = blocks[g] * gm[None, :]
    dmu = (ag @ kt).reshape(mu.movedim(g, 0).shape).movedim(0, g)
    y = (ag.T @ mu_g).reshape(kt.shape[0], *(blocks[i].shape[0] for i in others))
    letters = _AXIS_LETTERS[:len(others)]
    das = [None] * len(blocks)
    das[g] = p * gm[None, :]
    for j, i in enumerate(others):
        rest = [r for r in range(len(others)) if r != j]
        subs = "".join(f",n{letters[r]}" for r in rest)
        das[i] = torch.einsum(f"n{letters}{subs}->{letters[j]}n", y,
                              *(blocks[others[r]].T for r in rest))
    return dmu, das


class KronMoments(torch.autograd.Function):
    """(mean, var_red, var_add) of the Kronecker family with the hand-written
    backward of ``svgp.py:213-242``, whose matmuls ride
    ``config.MATMUL_PRECISION``. Called as ``apply(mu, *Ls, *blocks)``; the
    full family is its one-axis case, L and the Khatri–Rao block.

    At three axes or more the mean's contraction and its backward are three
    explicit products against the Khatri–Rao of all axes but the widest
    (:func:`_contract_forward`, :func:`_contract_backward`), each of Π m_i·n
    FMAs and inside a ``vggp.model.contract`` span; each forward counts one
    ``("kron_contract", Π m_i, n)`` in ``ops.cell_kuf.SHAPE_LAUNCHES``. An
    einsum's path, and so its largest intermediate, would depend on whether
    ``opt_einsum`` is installed: without it ∂μ wrote an m₁·m₂·n tensor.

    The backward reads t, r and v saved without a graph: it is exact to
    first order only (its Hessian was 0.19–0.43 of max|H| off
    ``jax.hessian``), so under ``create_graph`` it raises; inside
    ``common.second_order()`` the moments take plain autograd."""

    @staticmethod
    def forward(ctx, mu, *mats):
        d = len(mats) // 2
        Ls, blocks = mats[:d], mats[d:]
        if d >= 3:
            with span("vggp.model.contract"):
                mean, p, kt = _contract_forward(mu, blocks)
            var_red, var_add, ts, rs, vs = _var_terms(Ls, blocks)
            extra = (p, kt)
        else:
            mean, var_red, var_add, ts, rs, vs = _moments_math(mu, Ls, blocks)
            extra = ()
        ctx.d = d
        ctx.save_for_backward(mu, *Ls, *blocks, *ts, *rs, *vs, *extra)
        return mean, var_red, var_add

    @staticmethod
    def backward(ctx, gm, gr, gv):
        common.first_order_only("KronMoments")
        d = ctx.d
        saved = ctx.saved_tensors
        mu = saved[0]
        Ls, blocks, ts, rs, vs = (saved[1 + k * d:1 + (k + 1) * d] for k in range(5))
        with matmul_precision(config.MATMUL_PRECISION):
            if d >= 3:
                # opened here: a backward's device time would otherwise
                # fall to its forward operator's span
                with span("vggp.model.contract"):
                    dmu, da_means = _contract_backward(mu, blocks, *saved[1 + 5 * d:], gm)
            else:
                dmu_str, da_strs = _mean_cotangent_einsums(d)
                dmu = torch.einsum(dmu_str, gm, *blocks)
            dLs, das = [], []
            for i in range(d):
                others = [k for k in range(d) if k != i]
                r_oth = math.prod(rs[k] for k in others)
                v_oth = math.prod(vs[k] for k in others)
                if d >= 3:
                    da = da_means[i]
                else:
                    da = (torch.einsum(da_strs[i], mu, *[blocks[k] for k in others]) if others
                          else mu[:, None]) * gm[None, :]
                da = da + 2.0 * blocks[i] * (gr * r_oth)[None, :]
                dt = 2.0 * ts[i] * (gv * v_oth)[None, :]
                da = da + Ls[i] @ dt
                dLs.append(blocks[i] @ dt.T)   # ∂(t = Lᵀa)/∂L = a dtᵀ
                das.append(da)
        return (dmu, *dLs, *das)


@traced("vggp.model.moments")
def _qf_mean_var(spec: SVGPSpec, params: Params, blocks,
                 Ls=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Marginal q(f) mean and the two variance terms at the points whose
    whitened features are ``blocks`` (per-axis (m_i, n)); ``Ls`` the
    variational factor(s) of a warm state. The full family is the
    one-factor case: L against the (m, n) Khatri–Rao block."""
    q = params["q"]
    if Ls is None:
        Ls = _var_chols(spec, q)
    if spec.variational == "full":
        Ls, blocks = (Ls,), (common.khatri_rao_all(blocks),)
    if config.FAST_MOMENTS_BWD and not common.in_second_order():
        return KronMoments.apply(q["mu"], *Ls, *blocks)
    mean, var_red, var_add, *_ = _moments_math(q["mu"], Ls, blocks)
    return mean, var_red, var_add


@traced("vggp.model.kl")
@highest_precision
def kl(spec: SVGPSpec, params: Params) -> torch.Tensor:
    """KL[q(w) ‖ N(0, I)] in whitened coordinates."""
    q = params["q"]
    if spec.variational == "full":
        L = chol_from_raw(q["raw_L"])
        return 0.5 * (torch.sum(q["mu"] ** 2) + torch.sum(L * L) - L.shape[0]
                      - 2.0 * torch.sum(torch.log(torch.diagonal(L))))
    Ls = _kron_chols(spec, q)
    ms = [L.shape[0] for L in Ls]
    m_total = math.prod(ms)
    tr = math.prod(torch.sum(L * L) for L in Ls)
    logdet = 0.0
    for i, L in enumerate(Ls):
        others = m_total // ms[i]
        logdet = logdet + 2.0 * others * torch.sum(torch.log(torch.diagonal(L)))
    quad = torch.sum(q["mu"] ** 2)
    return 0.5 * (quad + tr - m_total - logdet)


@highest_precision
def elbo(spec: SVGPSpec, params: Params, xb: torch.Tensor, yb: torch.Tensor) -> torch.Tensor:
    """Minibatch ELBO estimate (scaled to the full dataset). The Gaussian
    expected log-likelihood stays inline; the others route through
    :func:`likelihoods.expected_log_lik`."""
    yb = yb.reshape(-1)
    nb = yb.shape[0]
    _, blocks = _whitened_blocks(spec, params, xb)
    mean, var_red, var_add = _qf_mean_var(spec, params, blocks)
    with span("vggp.model.likelihood"):
        mean = mean + common.mean_fn(spec, params, xb)
        kff = common.kdiag(spec, params, xb)
        var_f = torch.clamp(kff - var_red, min=0.0) + var_add
        noise = common.obs_noise(spec, params, xb)   # a scalar, or (nb,) per output
        if spec.likelihood == "gaussian":
            ell_i = (-0.5 * torch.log(2.0 * math.pi * noise)
                     - ((yb - mean) ** 2 + var_f) / (2.0 * noise))
        else:
            ell_i = likelihoods.expected_log_lik(spec.likelihood, yb, mean, var_f,
                                                 {**params, "noise": noise},
                                                 spec.likelihood_opts)
        ell = (spec.num_data / nb) * torch.sum(ell_i)
    return ell - kl(spec, params)


def loss(spec: SVGPSpec, params: Params, xb: torch.Tensor, yb: torch.Tensor) -> torch.Tensor:
    return -elbo(spec, params, xb, yb)


@highest_precision
def elbo_muS(spec: SVGPSpec, params: Params, mu: torch.Tensor, S: torch.Tensor,
             xb: torch.Tensor, yb: torch.Tensor) -> torch.Tensor:
    """The ELBO with the variational distribution given as q(w) = N(μ, S)
    (``params["q"]`` is ignored): what natural-gradient updates
    differentiate, in μ and S. Full family only; any likelihood."""
    if spec.variational != "full":
        raise ValueError("elbo_muS supports the full variational family")
    yb = yb.reshape(-1)
    nb = yb.shape[0]
    _, blocks = _whitened_blocks(spec, params, xb)
    a = common.khatri_rao_all(blocks)             # (m, n)
    mean = a.T @ mu + common.mean_fn(spec, params, xb)
    var_red = torch.sum(a * a, dim=0)
    var_add = torch.sum(a * (S @ a), dim=0)
    var_f = torch.clamp(common.kdiag(spec, params, xb) - var_red, min=0.0) + var_add
    noise = common.obs_noise(spec, params, xb)
    if spec.likelihood == "gaussian":
        ell_i = (-0.5 * torch.log(2.0 * math.pi * noise)
                 - ((yb - mean) ** 2 + var_f) / (2.0 * noise))
    else:
        ell_i = likelihoods.expected_log_lik(spec.likelihood, yb, mean, var_f,
                                             {**params, "noise": noise}, spec.likelihood_opts)
    # an S that is not positive definite gives NaN, as jnp.linalg.cholesky
    # does (and a natural-gradient guard then drops the step), not an error
    L, info = torch.linalg.cholesky_ex(S)
    L = torch.where(info == 0, L, torch.full_like(L, math.nan))
    kl_val = 0.5 * (torch.sum(mu * mu) + torch.trace(S) - S.shape[0]
                    - 2.0 * torch.sum(torch.log(torch.diagonal(L))))
    return (spec.num_data / nb) * torch.sum(ell_i) - kl_val


def _posterior_from_blocks(spec: SVGPSpec, params: Params, blocks, Ls, xstar,
                          full_cov: bool, predictive: bool) -> Gaussian:
    """q(f*) from the whitened blocks at ``xstar`` and the variational
    factors ``Ls``: marginals, or for ``full_cov`` the dense (n*, n*)
    covariance through the (m, n*) Khatri–Rao block (small n* only)."""
    mean, var_red, var_add = _qf_mean_var(spec, params, blocks, Ls=Ls)
    with span("vggp.model.likelihood"):
        mean = mean + common.mean_fn(spec, params, xstar)
        noise = common.obs_noise(spec, params, xstar) if predictive else 0.0
        if not full_cov:
            kss = common.kdiag(spec, params, xstar)
            var = torch.clamp(kss - var_red, min=0.0) + var_add + noise
            return Gaussian(mean=mean, var=var)
    a = common.khatri_rao_all(blocks)
    sa = _cov_half(spec, Ls, blocks)
    cov = common.gram_full(spec, params, xstar, xstar) - a.T @ a + sa.T @ sa
    if predictive:
        cov = cov + noise * torch.eye(cov.shape[0], dtype=cov.dtype, device=cov.device)
    return Gaussian(mean=mean, cov=cov)


def _wants_grad(params: Params) -> bool:
    leaves = [*(v for ax in params["axes"] for v in ax.values()), params["noise"],
              *params["q"].values(), *([params["mean"]] if "mean" in params else [])]
    return torch.is_grad_enabled() and any(t.requires_grad for t in leaves)


@highest_precision
def posterior(spec: SVGPSpec, params: Params, xstar: torch.Tensor,
              full_cov: bool = False, predictive: bool = False) -> Gaussian:
    """q(f*) at ``xstar`` (n*, d): marginals (mean, var), or mean and the
    dense covariance for ``full_cov``; ``predictive`` adds the noise.

    Serving (``torch.no_grad()``, or parameters that need no gradient) is
    the warm head on a fresh state, ``posterior_from_state(precompute(…))``:
    two (m_i, m_i) Cholesky factors and a few dense products cost less than
    the scalar chain of the closed-form F⁻¹. Under differentiation the
    blocks take the scalar-tangent whitening of training.
    """
    if not _wants_grad(params):
        return posterior_from_state(spec, params, precompute(spec, params), xstar,
                                    full_cov=full_cov, predictive=predictive)
    _, blocks = _whitened_blocks(spec, params, xstar)
    return _posterior_from_blocks(spec, params, blocks, _var_chols(spec, params["q"]), xstar,
                                  full_cov, predictive)


def posterior_predictive(spec: SVGPSpec, params: Params, xstar: torch.Tensor,
                         full_cov: bool = False) -> Gaussian:
    return posterior(spec, params, xstar, full_cov=full_cov, predictive=True)


def predict_y(spec: SVGPSpec, params: Params, xstar: torch.Tensor):
    """Observable-space prediction under the spec's likelihood: gaussian and
    student_t → Gaussian(mean, var + the observation variance); bernoulli →
    p(y* = 1) = Φ(μ/√(1+σ²)); poisson → (E[λ], Var[y])."""
    if spec.likelihood == "gaussian":
        return posterior_predictive(spec, params, xstar)
    q = posterior(spec, params, xstar, full_cov=False)
    if spec.likelihood == "bernoulli":
        return likelihoods.predict_bernoulli(q.mean, q.var)
    if spec.likelihood == "poisson":
        return likelihoods.predict_poisson(q.mean, q.var)
    df = dict(spec.likelihood_opts).get("df", 4.0)
    scale = df / max(df - 2.0, 1e-12)  # Var[T] = ν/(ν−2)·scale²
    return Gaussian(mean=q.mean, var=q.var + scale * params["noise"])


def prior(spec: SVGPSpec, params: Params, xstar: torch.Tensor) -> Gaussian:
    """Prior N(m, K**) at ``xstar``."""
    cov = common.gram_full(spec, params, xstar, xstar)
    mean = torch.zeros(cov.shape[0], dtype=cov.dtype, device=cov.device)
    return Gaussian(mean=mean + common.mean_fn(spec, params, xstar), cov=cov)


@highest_precision
def q_u(spec: SVGPSpec, params: Params) -> Gaussian:
    """q(u) = N(F μ, F S Fᵀ): the variational distribution unwhitened, with a
    dense (m, m) covariance (small m only)."""
    Fs = [c.F for c in common.axis_chol_kuu(spec, params)]
    if spec.variational == "full":
        F = kron_dense(Fs)
        half = F @ chol_from_raw(params["q"]["raw_L"])
        return Gaussian(mean=F @ params["q"]["mu"], cov=half @ half.T)
    Lk = _kron_chols(spec, params["q"])
    halves = [Fs[i] @ Lk[i] for i in range(spec.ndim)]
    return Gaussian(mean=_kron_contract(params["q"]["mu"], Fs, out="grid"),
                    cov=kron_dense([h @ h.T for h in halves]))


def _grid_r_blocks(chols, kvu_blocks) -> Tuple[torch.Tensor, ...]:
    """R_i = Kvu_i F_i⁻ᵀ (g_i, m_i), one whitening solve per axis."""
    return tuple(c.whiten(k.T).T for c, k in zip(chols, kvu_blocks))


@highest_precision
def p_v_u(spec: SVGPSpec, params: Params, grid_axes: Sequence) -> Gaussian:
    """p(v | u = E_q[u]): the cell integrals conditioned on the mean
    inducing state, with a dense (g, g) covariance (small grids only)."""
    chols = common.axis_chol_kuu(spec, params)
    r_blocks = _grid_r_blocks(chols, common.grid_kvu(spec, params, grid_axes))
    if spec.variational == "full":
        R = kron_dense(r_blocks)
        mean, RR = R @ params["q"]["mu"], R @ R.T
    else:
        mean = _kron_contract(params["q"]["mu"], r_blocks, out="grid")
        RR = kron_dense([R @ R.T for R in r_blocks])
    cov = common.grid_kvv(spec, params, grid_axes, dense=True) - RR
    return common.shift_mean(Gaussian(mean=mean, cov=cov),
                             common.grid_mean(spec, params, grid_axes))


def _grid_gaussian(spec: SVGPSpec, params: Params, r_blocks, kvv_blocks, Ls,
                   full_cov: bool) -> Gaussian:
    """A grid-product posterior from the whitened cross blocks R_i (g_i, m_i),
    the prior blocks Kvv_i and the variational factors ``Ls``:
    mean = (⊗R_i) μ and cov = Kvv − R Rᵀ + (R L_S)(R L_S)ᵀ; for
    ``full_cov=False`` only the per-cell variances, as Kronecker diagonals
    (O(g) memory). The full family takes the dense R = ⊗R_i (g, m)."""
    if spec.variational == "full":
        R = kron_dense(r_blocks)
        mean = R @ params["q"]["mu"]
        RS = R @ Ls
        if full_cov:
            return Gaussian(mean=mean, cov=kron_dense(kvv_blocks) - R @ R.T + RS @ RS.T)
        kvv_diag = kron_diag([torch.diagonal(b) for b in kvv_blocks])
        var = kvv_diag - torch.sum(R * R, dim=1) + torch.sum(RS * RS, dim=1)
        return Gaussian(mean=mean, var=common.floor_var(var, kvv_diag))
    mean = _kron_contract(params["q"]["mu"], r_blocks, out="grid")
    rs_blocks = [r_blocks[i] @ Ls[i] for i in range(spec.ndim)]
    if full_cov:
        cov = (kron_dense(kvv_blocks) - kron_dense([R @ R.T for R in r_blocks])
               + kron_dense([RS @ RS.T for RS in rs_blocks]))
        return Gaussian(mean=mean, cov=cov)
    kvv_diag = kron_diag([torch.diagonal(b) for b in kvv_blocks])
    var = (kvv_diag
           - kron_diag([torch.sum(R * R, dim=1) for R in r_blocks])
           + kron_diag([torch.sum(RS * RS, dim=1) for RS in rs_blocks]))
    return Gaussian(mean=mean, var=common.floor_var(var, kvv_diag))


def q_v(spec: SVGPSpec, params: Params, grid_axes: Sequence,
        full_cov: bool = False) -> Gaussian:
    """The gridded product q(v) over the cells of ``grid_axes`` (one cell
    feature per axis), with its per-cell uncertainty:
    R_i = Kvu_i F_i⁻ᵀ per axis, assembled by :func:`_grid_gaussian`."""
    return q_v_from_state(spec, params, precompute(spec, params), grid_axes, full_cov)


def q_dv(spec: SVGPSpec, params: Params, grid_axes: Sequence, axis: int,
         full_cov: bool = False) -> Gaussian:
    """The gridded-gradient product q(v'), v'_c = ∫_cell ∂f/∂x_axis: on
    ``axis`` a face difference of Kuf at the cell edges (the ``cell_kuf``
    kernel at (m, g + 1)), cell integrals elsewhere. Divide by the cell
    measure for the mean-gradient field."""
    return q_dv_from_state(spec, params, precompute(spec, params), grid_axes, axis, full_cov)


# The warm serving path: the per-axis Kuu factors and the variational
# Cholesky factors once, then every head is query-size work only. Rebuild
# the state after any parameter update: it is a pure function of ``params``.


def precompute(spec: SVGPSpec, params: Params):
    """(per-axis Kuu factors, the variational Cholesky factor(s))."""
    return common.axis_chol_kuu(spec, params), _var_chols(spec, params["q"])


@traced("vggp.entry.posterior")
@highest_precision
def posterior_from_state(spec: SVGPSpec, params: Params, state, xstar: torch.Tensor,
                         full_cov: bool = False, predictive: bool = False) -> Gaussian:
    """q(f*) from a :func:`precompute` state: no Kuu factorization, the
    whitening through the state's dense factors."""
    chols, Ls = state
    blocks = common.axis_whitened_kuf(spec, params, chols, xstar)
    return _posterior_from_blocks(spec, params, blocks, Ls, xstar, full_cov, predictive)


@highest_precision
def q_v_from_state(spec: SVGPSpec, params: Params, state, grid_axes: Sequence,
                   full_cov: bool = False) -> Gaussian:
    """q(v) from a :func:`precompute` state (the warm gridded-product head)."""
    chols, Ls = state
    r_blocks = _grid_r_blocks(chols, common.grid_kvu(spec, params, grid_axes))
    kvv_blocks = common.grid_kvv(spec, params, grid_axes, dense=False)
    g = _grid_gaussian(spec, params, r_blocks, kvv_blocks, Ls, full_cov)
    return common.shift_mean(g, common.grid_mean(spec, params, grid_axes))


@highest_precision
def q_dv_from_state(spec: SVGPSpec, params: Params, state, grid_axes: Sequence,
                    axis: int, full_cov: bool = False) -> Gaussian:
    """q(∫_cell ∂f/∂x_axis) from a :func:`precompute` state."""
    chols, Ls = state
    r_blocks = _grid_r_blocks(chols, common.grad_grid_kvu(spec, params, grid_axes, axis))
    kvv_blocks = common.grad_grid_kvv(spec, params, grid_axes, axis, dense=False)
    return _grid_gaussian(spec, params, r_blocks, kvv_blocks, Ls, full_cov)


def _grad_from_blocks(spec: SVGPSpec, params: Params, blocks, Ls, xstar, axis: int,
                      full_cov: bool) -> Gaussian:
    """q(∂f*/∂x_axis) from the whitened derivative blocks ∂a = F⁻¹∂Kuf:
    mean ∂aᵀμ, variance −k″(0)·Πσ² − ‖∂a‖² + ‖L_Sᵀ∂a‖² (floored), or the
    dense covariance for ``full_cov``."""
    mean, var_red, var_add = _qf_mean_var(spec, params, blocks, Ls=Ls)
    if not full_cov:
        kdd = common.grad_kdiag(spec, params, xstar, axis)
        var = torch.clamp(kdd - var_red, min=0.0) + var_add
        return Gaussian(mean=mean, var=common.floor_var(var, kdd))
    a = common.khatri_rao_all(blocks)
    sa = _cov_half(spec, Ls, blocks)
    cov = common.grad_gram_full(spec, params, xstar, xstar, axis) - a.T @ a + sa.T @ sa
    return Gaussian(mean=mean, cov=cov)


@highest_precision
def posterior_grad_from_state(spec: SVGPSpec, params: Params, state, xstar: torch.Tensor,
                              axis: int, full_cov: bool = False) -> Gaussian:
    """The pointwise-gradient posterior from a :func:`precompute` state."""
    chols, Ls = state
    blocks = common.axis_whitened_dkuf(spec, params, chols, xstar, axis)
    return _grad_from_blocks(spec, params, blocks, Ls, xstar, axis, full_cov)


@highest_precision
def posterior_grad(spec: SVGPSpec, params: Params, xstar: torch.Tensor, axis: int,
                   full_cov: bool = False) -> Gaussian:
    """The posterior of the pointwise gradient ∂f/∂x_axis at ``xstar``: the
    exact linear-functional posterior through the dense Kuu factors. Needs
    a once-differentiable kind on ``axis`` (Matérn-1/2 raises ValueError)."""
    chols = common.axis_chol_kuu(spec, params)
    blocks = common.axis_whitened_dkuf(spec, params, chols, xstar, axis)
    return _grad_from_blocks(spec, params, blocks, _var_chols(spec, params["q"]), xstar,
                             axis, full_cov)


class SVGP(nn.Module):
    """The SVGP as a module: holds the raw (unconstrained) parameters as
    ``nn.Parameter``s, in the layout of the JAX parameter tree (``axes`` →
    one ``ParameterDict`` per axis, ``noise``, ``q``, and ``mean`` when it
    is learned)."""

    def __init__(self, spec: SVGPSpec, params: Params = None, dtype=torch.float32,
                 device=None):
        super().__init__()
        from vggp_tpu_torch import train

        if params is None:
            params = spec.init_params(dtype, device)
        raw = train.unconstrain(params)
        self.spec = spec
        common.module_params(self, raw)
        self.q = nn.ParameterDict({k: nn.Parameter(v.detach().clone())
                                   for k, v in raw["q"].items()})

    def raw_params(self) -> Params:
        """The nested raw tree, its leaves the module's parameters."""
        return {**common.module_raw_params(self), "q": dict(self.q.items())}

    def params(self) -> Params:
        """The constrained parameter tree the model functions take."""
        from vggp_tpu_torch import train

        return train.constrain(self.raw_params())

    def forward(self, xb: torch.Tensor, yb: torch.Tensor) -> torch.Tensor:
        """The minibatch loss (negative ELBO)."""
        return loss(self.spec, self.params(), xb, yb)

    def posterior(self, xstar: torch.Tensor, full_cov: bool = False,
                  predictive: bool = False) -> Gaussian:
        return posterior(self.spec, self.params(), xstar, full_cov=full_cov,
                         predictive=predictive)

    def q_v(self, grid_axes=None, full_cov: bool = False) -> Gaussian:
        """The gridded product; ``grid_axes`` defaults to the model's own cells."""
        return q_v(self.spec, self.params(), grid_axes or self.spec.features, full_cov)

    def q_dv(self, grid_axes=None, axis: int = 0, full_cov: bool = False) -> Gaussian:
        """The gridded-gradient product along ``axis``; ``grid_axes`` defaults
        to the model's own cells."""
        return q_dv(self.spec, self.params(), grid_axes or self.spec.features, axis, full_cov)

    def precompute(self):
        """The warm serving state of the current parameters (:func:`precompute`)."""
        return precompute(self.spec, self.params())
