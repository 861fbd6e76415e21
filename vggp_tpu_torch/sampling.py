"""Pathwise sampling: the prior-path layer and the Matheron samplers of every
model family (port of ``vggp_tpu/sampling.py``).

A prior path is a random-Fourier-feature draw
f(x) = amp · Σ_j cos(Σ_k ω_kj x_k + b_j), amp = σ_total·√(2/F). For the
separable Matérn product kernels the spectral measure factorizes per axis,
each a Student-t with 2ν degrees of freedom and scale 1/ℓ (a Cauchy for
Matérn-1/2, a normal for the RBF). Every inducing and grid functional of
such a path is exact and closed form: cell integrals of e^{iωs}, point
values, the Markov-RKHS projections of the VFF and spline features, and the
face differences of the gridded-gradient product. Complex values are carried
as (re, im) pairs of real tensors, as in the JAX package.

Random draws take an explicit ``torch.Generator`` in place of a JAX key.
They are made in float64 on the generator's device and cast to the
parameters' dtype and device, so one seed gives a float32 and a float64 run
the same draws. Over these paths, :func:`pathwise` and :func:`pathwise_q_v`
draw coherent posterior functions and gridded products of the dense models
(Matheron's rule, Wilson et al. 2020); the matrix-free samplers are in
``models.iterative``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from vggp_tpu_torch import kernels
from vggp_tpu_torch.config import highest_precision
from vggp_tpu_torch.features import (B1SplineFeature, CellIntegralFeature, FourierFeature,
                                     PointFeature, SplineRKHSFeature)
from vggp_tpu_torch.models import common
from vggp_tpu_torch.ops.chol import solve_psd, tri_solve

_DF = {"matern12": 1, "matern32": 3, "matern52": 5}


def _draw(fn, gen: torch.Generator, shape, like: torch.Tensor) -> torch.Tensor:
    """``fn`` (torch.randn or torch.rand) of ``shape`` in float64 from
    ``gen``, cast to ``like``'s dtype and device."""
    out = fn(shape, generator=gen, dtype=torch.float64, device=gen.device)
    return out.to(dtype=like.dtype, device=like.device)


def normal(gen: torch.Generator, shape, like: torch.Tensor) -> torch.Tensor:
    """Standard normal draws of ``shape`` from ``gen``, made in float64 and
    cast to ``like``'s dtype and device."""
    return _draw(torch.randn, gen, shape, like)


def uniform(gen: torch.Generator, shape, like: torch.Tensor) -> torch.Tensor:
    """U[0, 1) draws of ``shape`` from ``gen``, made in float64 and cast to
    ``like``'s dtype and device."""
    return _draw(torch.rand, gen, shape, like)


def sample_gaussian(gen: torch.Generator, g, n_samples: int) -> torch.Tensor:
    """(n_samples, n) draws from a :class:`models.common.Gaussian`: joint
    where the covariance is materialized, independent marginals where only
    the variance is. The covariance takes a relative nugget of 1e-6 in
    float32 (1e-12 in float64): its roundoff-level indefiniteness would
    fail the Cholesky."""
    n = g.mean.shape[0]
    z = normal(gen, (n_samples, n), g.mean)
    if g.cov is not None:
        rel = 1e-6 if g.mean.dtype == torch.float32 else 1e-12
        eps = rel * torch.mean(torch.diagonal(g.cov))
        L = torch.linalg.cholesky(g.cov + eps * torch.eye(n, dtype=g.mean.dtype,
                                                          device=g.mean.device))
        return g.mean[None, :] + z @ L.T
    return g.mean[None, :] + z * torch.sqrt(g.var)[None, :]


def sample_frequencies(gen: torch.Generator, kind: str, lengthscale, n_features: int):
    """One axis's spectral frequencies ω ~ S(ω)/(2πσ²), (F,).

    Matérn-ν is a Student-t with df = 2ν and scale λ/√df = 1/ℓ, drawn as
    z/√(χ²_df/df) with χ²_df the sum of df squared normals (df ∈ {1, 3, 5});
    the RBF is N(0, 1/ℓ²).
    """
    if kind == "rbf":
        return normal(gen, (n_features,), lengthscale) / lengthscale
    df = _DF[kind]
    lam = kernels.lam(kind, lengthscale)
    z = normal(gen, (n_features,), lengthscale)
    chi2 = torch.sum(normal(gen, (df, n_features), lengthscale) ** 2, dim=0)
    return (lam / math.sqrt(df)) * z / torch.sqrt(chi2 / df)


def _phases(gen: torch.Generator, n_features: int, like: torch.Tensor) -> torch.Tensor:
    return _draw(torch.rand, gen, (n_features,), like) * (2.0 * math.pi)


def prior_paths(gen: torch.Generator, spec, params, n_features: int):
    """Spectral prior-path coefficients (omegas (d, F), phases (F,), amp)."""
    if kernels.COREGION_KIND in spec.kinds:
        raise NotImplementedError(
            "prior_paths is single-output; a coregion spec draws through "
            "prior_paths_multioutput (chol(B)-mixed per-output bundles)")
    omegas = []
    var_total = 1.0
    for i, kind in enumerate(spec.kinds):
        p = common.axis_params(params, i)
        omegas.append(sample_frequencies(gen, kind, p["lengthscale"], n_features))
        var_total = var_total * p["variance"]
    phases = _phases(gen, n_features, omegas[0])
    amp = torch.sqrt(2.0 * var_total / n_features)
    return torch.stack(omegas), phases, amp


def eval_path(omegas, phases, amp, X: torch.Tensor) -> torch.Tensor:
    """The prior path at (n, d) inputs → (n,)."""
    if X.dim() == 1:
        X = X[:, None]
    return amp * torch.sum(torch.cos(X @ omegas + phases[None, :]), dim=1)


# --------------------------------------------------------------------------- #
# multi-output (ICM coregion axis) prior paths (``sampling.py:126-242``)
#
# The joint prior over (x, output p) is B ⊗ K, so a coherent draw is
# f(x, p) = Σ_r L_B[p, r] · g_r(x) with L_B = chol(B) and g_r independent
# paths over the continuous axes. Every linear functional inherits the mixing.
# --------------------------------------------------------------------------- #


class _ContSubSpec(NamedTuple):
    """The continuous axes of a coregion spec, for the path functionals."""

    kinds: tuple
    features: tuple

    @property
    def ndim(self) -> int:
        return len(self.kinds)


def _coregion_split(spec):
    """(the coregion axis's index, the continuous axes' subspec), or
    (None, spec)."""
    if kernels.COREGION_KIND not in spec.kinds:
        return None, spec
    co = spec.kinds.index(kernels.COREGION_KIND)
    kinds = tuple(k for i, k in enumerate(spec.kinds) if i != co)
    feats = tuple(f for i, f in enumerate(getattr(spec, "features", ()) or ()) if i != co)
    return co, _ContSubSpec(kinds=kinds, features=feats)


def _cont_params(params, co):
    return {"axes": tuple(ax for i, ax in enumerate(params["axes"]) if i != co),
            "noise": params["noise"]}


def prior_paths_multioutput(gen: torch.Generator, spec, params, n_features: int):
    """P chol(B)-mixed bundles: (omegas (P, d_cont, F), phases (P, F), amp,
    L_B (P, P), the coregion axis). amp carries the continuous axes'
    variances; B carries the output scales."""
    co, _ = _coregion_split(spec)
    B = kernels.coregion_b(common.axis_params(params, co))
    P = B.shape[0]
    # B = WWᵀ + diag(κ) is PD by construction; the jitter guards float32 only
    LB = torch.linalg.cholesky(B + 1e-10 * torch.eye(P, dtype=B.dtype, device=B.device))
    cont = [i for i in range(spec.ndim) if i != co]
    var_total = 1.0
    for i in cont:
        var_total = var_total * common.axis_params(params, i)["variance"]
    om_all, ph_all = [], []
    for _ in range(P):
        om_all.append(torch.stack([
            sample_frequencies(gen, spec.kinds[i], common.axis_params(params, i)["lengthscale"],
                               n_features) for i in cont]))
        ph_all.append(_phases(gen, n_features, om_all[-1]))
    amp = torch.sqrt(2.0 * var_total / n_features)
    return torch.stack(om_all), torch.stack(ph_all), amp, LB, co


def eval_path_multioutput(omegas, phases, amp, LB, co, X: torch.Tensor) -> torch.Tensor:
    """The mixed multi-output path at (n, d) inputs, the coregion column
    holding integer output indices → (n,)."""
    if X.dim() == 1:
        X = X[:, None]
    cont = [i for i in range(X.shape[1]) if i != co]
    Xc = X[:, cont]
    idx = torch.round(X[:, co]).long()
    bundle = torch.stack([eval_path(om, ph, amp, Xc) for om, ph in zip(omegas, phases)])
    return torch.sum(LB[idx, :] * bundle.T, dim=1)


def _mix_outputs(LB, parts, co) -> torch.Tensor:
    """Σ_r L_B[p, r] · parts[r] with the output axis p put in slot ``co``."""
    return torch.movedim(torch.tensordot(LB, parts, dims=([1], [0])), 0, co)


def prior_inducing_sample_multioutput(omegas, phases, amp, LB, co, spec, params):
    """The exact u_prior of a coregion spec → (m₁, …, m_d), the output axis
    (length P) in its spec slot."""
    _, sub = _coregion_split(spec)
    p_cont = _cont_params(params, co)
    u_r = torch.stack([prior_inducing_sample(omegas[r], phases[r], amp, sub, p_cont)
                       for r in range(LB.shape[0])])
    return _mix_outputs(LB, u_r, co)


def eval_path_deriv(omegas, phases, amp, X: torch.Tensor, orders) -> torch.Tensor:
    """The mixed partial ∂^{o₁}_{x₁}…∂^{o_d}_{x_d} of the prior path → (n,):
    each derivative advances the phase by π/2 and multiplies by the axis
    frequency."""
    if X.dim() == 1:
        X = X[:, None]
    n_total = int(sum(orders))
    arg = X @ omegas + phases[None, :] + 0.5 * math.pi * n_total
    coef = torch.ones_like(phases)
    for k, o in enumerate(orders):
        for _ in range(int(o)):
            coef = coef * omegas[k]
    return amp * torch.sum(coef[None, :] * torch.cos(arg), dim=1)


# --------------------------------------------------------------------------- #
# (re, im) pairs and the cell and face functionals (``sampling.py:245-395``)
# --------------------------------------------------------------------------- #


def _cmul(a, b):
    """(re, im) product of two pairs."""
    return a[0] * b[0] - a[1] * b[1], a[0] * b[1] + a[1] * b[0]


def _cexp(theta):
    """e^{iθ} as a pair."""
    return torch.cos(theta), torch.sin(theta)


def _cpow_int(a, p: int):
    """Integer power p ≥ 1 of a pair."""
    out = a
    for _ in range(p - 1):
        out = _cmul(out, a)
    return out


def _mesh_of(feat, like: torch.Tensor) -> torch.Tensor:
    """A cell feature's edges in ``like``'s dtype and on its device (the
    feature's cached copy)."""
    return feat.mesh_j({"lengthscale": like})


def _cell_integral_pair(mesh: torch.Tensor, omega: torch.Tensor):
    """∫_cell e^{iωs} ds for every cell × frequency → (re, im), each (m, F):
    re = (sin ωβ − sin ωα)/ω, im = −(cos ωβ − cos ωα)/ω, and the cell width
    at ω = 0."""
    lo, hi = mesh[:-1][:, None], mesh[1:][:, None]
    w = omega[None, :]
    tiny = torch.abs(w) < 1e-12
    ws = torch.where(tiny, 1.0, w)
    re = (torch.sin(ws * hi) - torch.sin(ws * lo)) / ws
    im = -(torch.cos(ws * hi) - torch.cos(ws * lo)) / ws
    return torch.where(tiny, hi - lo, re), torch.where(tiny, 0.0, im)


def prior_inducing_sample(omegas, phases, amp, spec, params) -> torch.Tensor:
    """The exact u_prior, the inducing functionals of the prior path →
    (m₁, …, m_d): closed-form cell integrals, point values, and the
    Markov-RKHS projections of the VFF and spline features."""
    return _accumulate_factors(phases, amp, _point_factors(omegas, spec, params))


def _accumulate_factors(phases, amp, factors) -> torch.Tensor:
    """amp · Σ_j Re[e^{i b_j} Π_k factor_kj] over per-axis (re, im) factors.
    The running product covers all but the last factor, which is contracted
    over F as a matmul (no (m₁, …, m_d, F) intermediate)."""
    pr, pi = torch.cos(phases), torch.sin(phases)
    for fr, fi in factors[:-1]:
        pr, pi = (pr[..., None, :] * fr - pi[..., None, :] * fi,
                  pr[..., None, :] * fi + pi[..., None, :] * fr)
    fr, fi = factors[-1]
    return amp * (pr @ fr.T - pi @ fi.T)


def prior_grid_integral_sample(omegas, phases, amp, grid_axes) -> torch.Tensor:
    """The exact v_prior, cell integrals of the prior path over a product
    grid → (g₁, …, g_d)."""
    factors = [_cell_integral_pair(_mesh_of(g, omegas), omegas[k])
               for k, g in enumerate(grid_axes)]
    return _accumulate_factors(phases, amp, factors)


def _face_diff_pair(mesh: torch.Tensor, omega: torch.Tensor):
    """e^{iωβ} − e^{iωα} for every cell × frequency → (re, im), each (g, F):
    ∫_cell ∂f = f(β) − f(α), the gradient product's axis functional."""
    lo, hi = mesh[:-1][:, None], mesh[1:][:, None]
    w = omega[None, :]
    return (torch.cos(w * hi) - torch.cos(w * lo), torch.sin(w * hi) - torch.sin(w * lo))


def prior_grid_grad_sample(omegas, phases, amp, grid_axes, axis: int) -> torch.Tensor:
    """The exact v'_prior, cell integrals of ∂f/∂x_axis of the prior path →
    (g₁, …, g_d): face differences on ``axis``, cell integrals elsewhere
    (the functional of ``common.grad_grid_kvu``)."""
    factors = [(_face_diff_pair if k == axis else _cell_integral_pair)(
        _mesh_of(g, omegas), omegas[k]) for k, g in enumerate(grid_axes)]
    return _accumulate_factors(phases, amp, factors)


def prior_grid_integral_sample_multioutput(omegas, phases, amp, LB, co,
                                           grid_axes) -> torch.Tensor:
    """The exact v_prior of a coregion spec's product grid → (g₁, …, g_d),
    the output axis (length P) in its slot. The grid's output axis must be
    the model's outputs (``OutputFeature.Kvu``)."""
    P = LB.shape[0]
    g_co = grid_axes[co]
    if getattr(g_co, "n_outputs", None) != P:
        raise ValueError(
            f"grid axis {co} of a coregion spec must be "
            f"OutputFeature(n_outputs={P}), got {type(g_co).__name__}")
    cont_axes = tuple(g for i, g in enumerate(grid_axes) if i != co)
    v_r = torch.stack([prior_grid_integral_sample(omegas[r], phases[r], amp, cont_axes)
                       for r in range(P)])
    return _mix_outputs(LB, v_r, co)


def prior_grid_grad_sample_multioutput(omegas, phases, amp, LB, co, grid_axes,
                                       axis: int) -> torch.Tensor:
    """The coregion form of :func:`prior_grid_grad_sample` (``axis`` a
    continuous axis, indexed in the full spec)."""
    if axis == co:
        raise ValueError("cannot differentiate along the discrete output axis")
    cont_axes = tuple(g for i, g in enumerate(grid_axes) if i != co)
    cont_axis = axis - (1 if axis > co else 0)
    v_r = torch.stack([prior_grid_grad_sample(omegas[r], phases[r], amp, cont_axes, cont_axis)
                       for r in range(LB.shape[0])])
    return _mix_outputs(LB, v_r, co)


# --------------------------------------------------------------------------- #
# Markov-RKHS functionals of the projection-defined features
# (``sampling.py:398-617``)
#
# VFF and spline inducing variables are RKHS projections u_j = ⟨f, φ_j⟩_H.
# Every half-integer Matérn RKHS has the Markov-state form
#   ⟨g, h⟩_H = (1/c) ∫_a^b (Lg)(Lh) dt + state_g(a)ᵀ P₀⁻¹ state_h(a),
# L = (d/dt + λ)^p, so for g = e^{iωx} (Lg = (λ + iω)^p e^{iωx}) the
# functional reduces to closed-form integrals of e^{iωx} against Lφ_j.
# --------------------------------------------------------------------------- #


def _E_interval(u: torch.Tensor, T):
    """∫_0^T e^{iut} dt = sin(uT)/u + i(1 − cos(uT))/u, by series near 0."""
    theta = u * T
    small = torch.abs(theta) < 1e-3
    us = torch.where(small, 1.0, u)
    re = torch.sin(theta) / us
    im = (1.0 - torch.cos(theta)) / us
    re_s = T * (1.0 - theta ** 2 / 6.0)
    im_s = T * (theta / 2.0 - theta ** 3 / 24.0)
    return torch.where(small, re_s, re), torch.where(small, im_s, im)


_J_SERIES_TERMS = 20  # θ^20/20! at |θ| = 2 ≈ 4e-13


def _J_powers(theta: torch.Tensor, cmax: int):
    """J_c(θ) = ∫_0^1 e^{iθv} v^c dv for c = 0..cmax, as pairs: the upward
    recursion J_c = (e^{iθ} − c·J_{c−1})/(iθ) for |θ| ≥ 2, the Taylor
    series Σ_k (iθ)^k/(k!(c + k + 1)) below."""
    small = torch.abs(theta) < 2.0
    ct, st = torch.cos(theta), torch.sin(theta)
    ths = torch.where(small, 1.0, theta)

    ts = torch.where(small, theta, 0.0)
    tr, ti = torch.ones_like(ts), torch.zeros_like(ts)  # (iθ)^k / k!
    accs = [(torch.zeros_like(ts), torch.zeros_like(ts)) for _ in range(cmax + 1)]
    for k in range(_J_SERIES_TERMS):
        for c in range(cmax + 1):
            accs[c] = (accs[c][0] + tr / (c + k + 1.0), accs[c][1] + ti / (c + k + 1.0))
        tr, ti = _cmul((tr, ti), (torch.zeros_like(ts), ts))
        tr, ti = tr / (k + 1.0), ti / (k + 1.0)

    jr, ji = st / ths, (1.0 - ct) / ths
    out = [(torch.where(small, accs[0][0], jr), torch.where(small, accs[0][1], ji))]
    for c in range(1, cmax + 1):
        xr, xi = ct - c * jr, st - c * ji
        jr, ji = xi / ths, -xr / ths
        out.append((torch.where(small, accs[c][0], jr), torch.where(small, accs[c][1], ji)))
    return tuple(out)


def _markov_prefactor(kind: str, p_ax, omega: torch.Tensor):
    """(λ, p, (λ + iω)^p / c as a pair) of one axis's Markov RKHS."""
    lam = kernels.lam(kind, p_ax["lengthscale"])
    p = kernels.MARKOV_ORDER[kind]
    c = kernels.white_noise_intensity(kind, p_ax["variance"], p_ax["lengthscale"])
    pref = _cpow_int((lam * torch.ones_like(omega), omega), p)
    return lam, p, (pref[0] / c, pref[1] / c)


def _state_term(kind: str, p_ax, omega: torch.Tensor, a: float, state_rows):
    """The boundary part Σ_{r,s} (iω)^r e^{iωa} P₀⁻¹[r, s] φ_j^{(s)}(a) →
    pair (m, F); ``state_rows`` are the (m,) basis-state values at a. The
    zeros of P₀⁻¹ (Python floats) are skipped."""
    pinv = kernels.p0_inv_rows(kind, p_ax["variance"], p_ax["lengthscale"])
    phase = _cexp(omega * a)
    one, zero = torch.ones_like(omega), torch.zeros_like(omega)
    iw_pows = [(one, zero), (zero, omega), (-(omega ** 2), zero)]
    out_r = 0.0
    out_i = 0.0
    for r in range(len(pinv)):
        wr = _cmul(iw_pows[r], phase)
        for s in range(len(pinv)):
            if isinstance(pinv[r][s], float) and pinv[r][s] == 0.0:
                continue
            coef = pinv[r][s] * state_rows[s][:, None]
            out_r = out_r + coef * wr[0][None, :]
            out_i = out_i + coef * wr[1][None, :]
    return out_r, out_i


def _rkhs_fourier_factor(feat: FourierFeature, kind: str, p_ax, omega):
    """⟨e^{iωx}, φ_j⟩_H for the VFF basis → pair (m, F): the integral part a
    two-term combination of E(ω ± ω_j) per feature, the boundary part from
    the basis state (cos_j: (1, 0, −ω_j²); sin_j: (0, ω_j, 0)) at a."""
    lam, p, pref = _markov_prefactor(kind, p_ax, omega)
    om_j = feat.omegas(p_ax["lengthscale"])
    T = feat.b - feat.a
    Ep = _E_interval(omega[None, :] + om_j[:, None], T)
    Em = _E_interval(omega[None, :] - om_j[:, None], T)
    lam_col = lam * torch.ones_like(om_j)
    zp = _cpow_int((lam_col, om_j), p)
    zm = _cpow_int((lam_col, -om_j), p)
    tp = _cmul((zp[0][:, None], zp[1][:, None]), Ep)
    tm = _cmul((zm[0][:, None], zm[1][:, None]), Em)
    I_cos = (0.5 * (tp[0] + tm[0]), 0.5 * (tp[1] + tm[1]))
    # (tp − tm)/(2i): (x + iy)/(2i) = y/2 − i·x/2
    I_sin = (0.5 * (tp[1] - tm[1]), -0.5 * (tp[0] - tm[0]))
    integ = (torch.cat([I_cos[0], I_sin[0][1:]], dim=0),
             torch.cat([I_cos[1], I_sin[1][1:]], dim=0))
    mult = _cmul(pref, _cexp(omega * feat.a))
    factor = (integ[0] * mult[0][None, :] - integ[1] * mult[1][None, :],
              integ[0] * mult[1][None, :] + integ[1] * mult[0][None, :])

    zc = torch.zeros_like(om_j)
    zs = torch.zeros_like(om_j[1:])
    rows = [torch.cat([torch.ones_like(om_j), zs])]
    if p >= 2:
        rows.append(torch.cat([zc, om_j[1:]]))
    if p >= 3:
        rows.append(torch.cat([-(om_j ** 2), zs]))
    st = _state_term(kind, p_ax, omega, feat.a, rows)
    return factor[0] + st[0], factor[1] + st[1]


def _poly_rkhs_factor(kind: str, p_ax, omega, a: float, delta: float,
                      coeffs: np.ndarray, m: int, state_rows):
    """⟨e^{iωx}, φ_j⟩_H for a uniform piecewise-polynomial basis → pair
    (m, F). ``coeffs`` is the static (K, S, C) table: basis j = i + s is
    Σ_c coeffs[i, s, c]·v^c on interval i (v = (x − lo_i)/δ), so
    Lφ_j = Σ_r C(p, r) λ^{p−r} δ^{−r} D^r of the table (D = d/dv) and
    ∫_i e^{iωx}·poly(v) dx = δ·e^{iω·lo_i}·Σ_c coef_c·J_c(ωδ)."""
    lam, p, pref = _markov_prefactor(kind, p_ax, omega)
    K, S, C = coeffs.shape

    def dmat(n):  # d/dv on coefficient vectors of length C
        d = np.zeros((C, C))
        for k in range(1, C):
            d[k - 1, k] = k
        out = np.eye(C)
        for _ in range(n):
            out = d @ out
        return out

    Lcoef = 0.0
    for r in range(p + 1):
        tab = np.einsum("cd,isd->isc", dmat(r), coeffs)
        Lcoef = Lcoef + (math.comb(p, r) * delta ** (-r)) * (
            lam ** (p - r) * torch.as_tensor(tab, dtype=lam.dtype, device=lam.device))

    Js = _J_powers(omega * delta, C - 1)
    Jr = torch.stack([j[0] for j in Js], dim=0)  # (C, F)
    Ji = torch.stack([j[1] for j in Js], dim=0)
    er = torch.einsum("isc,cf->isf", Lcoef, Jr)
    ei = torch.einsum("isc,cf->isf", Lcoef, Ji)
    lo = a + delta * torch.arange(K, dtype=lam.dtype, device=lam.device)
    ph = _cexp(omega[None, :] * lo[:, None])
    contrib_r = delta * (ph[0][:, None, :] * er - ph[1][:, None, :] * ei)
    contrib_i = delta * (ph[0][:, None, :] * ei + ph[1][:, None, :] * er)
    Ir = torch.zeros((m, omega.shape[0]), dtype=lam.dtype, device=lam.device)
    Ii = torch.zeros_like(Ir)
    for s in range(S):
        Ir[s:s + K] += contrib_r[:, s]
        Ii[s:s + K] += contrib_i[:, s]
    out_r = Ir * pref[0][None, :] - Ii * pref[1][None, :]
    out_i = Ir * pref[1][None, :] + Ii * pref[0][None, :]
    st = _state_term(kind, p_ax, omega, a, state_rows)
    return out_r + st[0], out_i + st[1]


def _rkhs_b1_factor(feat: B1SplineFeature, kind: str, p_ax, omega):
    """⟨e^{iωx}, hat_j⟩_H, the hats as degree-1 piecewise polynomials."""
    m = feat.m
    coeffs = np.zeros((m - 1, 2, 2))   # interval i: hat_i is 1 − v, hat_{i+1} is v
    coeffs[:, 0, 0] = 1.0
    coeffs[:, 0, 1] = -1.0
    coeffs[:, 1, 1] = 1.0
    state = [torch.as_tensor(np.eye(1, m, 0)[0], dtype=omega.dtype, device=omega.device)]
    return _poly_rkhs_factor(kind, p_ax, omega, float(feat.mesh[0]), feat.delta,
                             coeffs, m, state)


def _rkhs_spline_factor(feat: SplineRKHSFeature, kind: str, p_ax, omega):
    """⟨e^{iωx}, B_j⟩_H for the degree-2/3 open-clamped B-spline basis."""
    state = [torch.as_tensor(feat._state[r], dtype=omega.dtype, device=omega.device)
             for r in range(feat.degree)]
    return _poly_rkhs_factor(kind, p_ax, omega, feat.a, feat.delta,
                             np.asarray(feat._coeffs), feat.m, state)


def _axis_factor(feat, kind: str, p_ax, omega):
    """One axis's inducing functionals of e^{iωx} → (re, im), each (m, F)."""
    if isinstance(feat, CellIntegralFeature):
        return _cell_integral_pair(_mesh_of(feat, omega), omega)
    if isinstance(feat, PointFeature):
        arg = p_ax["z"][:, None] * omega[None, :]
        return torch.cos(arg), torch.sin(arg)
    if isinstance(feat, FourierFeature):
        return _rkhs_fourier_factor(feat, kind, p_ax, omega)
    if isinstance(feat, SplineRKHSFeature):
        return _rkhs_spline_factor(feat, kind, p_ax, omega)
    if isinstance(feat, B1SplineFeature):
        return _rkhs_b1_factor(feat, kind, p_ax, omega)
    raise NotImplementedError(type(feat).__name__)


def _point_factors(omegas, spec, params):
    """Per-axis inducing functionals of e^{iωx} → a list of (re, im) pairs."""
    return [_axis_factor(spec.features[k], spec.kinds[k], common.axis_params(params, k),
                         omegas[k]) for k in range(spec.ndim)]


def _whiten_axes(w: torch.Tensor, chols) -> torch.Tensor:
    """The per-axis whitening solve F_k⁻¹ along every axis of ``w``."""
    for k in range(w.dim()):
        moved = torch.movedim(w, k, 0)
        solved = chols[k].whiten(moved.reshape(w.shape[k], -1))
        w = torch.movedim(solved.reshape(moved.shape), 0, k)
    return w


# --------------------------------------------------------------------------- #
# the pathwise samplers (``sampling.py:658-1227``)
#
# Matheron's rule in whitened coordinates,
#   f_s(x) = f_prior,s(x) + a(x)ᵀ (w_q,s − F⁻¹ u_prior,s),
# with a(x) the per-axis whitened blocks and w_q,s a draw of q(w): μ + L_S z
# for the SVGP, L_B⁻ᵀ(c + z) from the collapsed families' factored state
# (q*(w) = N(L_B⁻ᵀc, B⁻¹)); the exact GP updates against the data itself,
#   f_s(x) = f_prior,s(x) + k(x, X)(Kxx + σ²I)⁻¹(y − f_prior,s(X) − ε_s).
# Each sampler draws its samples' paths and z (or ε) from ``gen`` one sample
# at a time, in the order the JAX package's per-sample function draws them;
# the heavy work of all S samples then runs batched: the whitening of the S
# inducing functionals as the columns of one solve per axis, the Kronecker
# contraction of the S residuals, one (S, m) @ (m, n*) product, the exact
# GP's S solves as columns.
# --------------------------------------------------------------------------- #


def _stack_draws(n_samples: int, one) -> list:
    """``one()``, a tuple of tensors, for each sample in turn → the list of
    each slot's (S, …) stack."""
    rows = [one() for _ in range(n_samples)]
    return [torch.stack(col) for col in zip(*rows)]


def _path_and_u(gen, spec, params, n_features: int, xstar, co):
    """One sample's prior path at ``xstar`` and its exact u_prior, through
    the chol(B)-mixed bundles when ``co`` is a coregion axis."""
    if co is None:
        om, ph, amp = prior_paths(gen, spec, params, n_features)
        return eval_path(om, ph, amp, xstar), prior_inducing_sample(om, ph, amp, spec, params)
    om, ph, amp, LBm, _ = prior_paths_multioutput(gen, spec, params, n_features)
    return (eval_path_multioutput(om, ph, amp, LBm, co, xstar),
            prior_inducing_sample_multioutput(om, ph, amp, LBm, co, spec, params))


def _whiten_samples(U: torch.Tensor, chols) -> torch.Tensor:
    """F⁻¹u for S stacked inducing tensors (S, m₁, …, m_d): one whitening
    solve per axis over all samples' columns."""
    from vggp_tpu_torch.models.iterative import _along_axes

    return _along_axes(U, [c.whiten for c in chols])


def _z_shape(spec) -> tuple:
    """The shape of one q(w) draw's standard normal: (m,) for the full
    family, ``axis_m`` for the Kronecker one."""
    return (spec.num_inducing,) if spec.variational == "full" else tuple(spec.axis_m)


def _svgp_diff_sample(spec, params, W: torch.Tensor, Z: torch.Tensor) -> torch.Tensor:
    """The Matheron residuals w_q − F⁻¹u_prior of S samples for the
    (whitened) SVGP family, from the whitened prior functionals ``W`` and
    the standard normals ``Z``: (S, m) for the full family, (S, m₁, …, m_d)
    for the Kronecker family."""
    from vggp_tpu_torch.models.iterative import _along_axes
    from vggp_tpu_torch.models.svgp import _kron_chols, chol_from_raw

    q = params["q"]
    if spec.variational == "full":
        w_q = q["mu"] + Z @ chol_from_raw(q["raw_L"]).T
        return w_q - W.reshape(W.shape[0], -1)
    lz = _along_axes(Z, [lambda v, L=L: L @ v for L in _kron_chols(spec, q)])
    return q["mu"] + lz - W


def _apply_blocks(spec, diff: torch.Tensor, blocks) -> torch.Tensor:
    """Contract S Matheron residuals against per-axis whitened blocks →
    (S, n): through the Khatri–Rao block for the full family's (S, m), one
    axis at a time (``svgp._kron_contract``'s sum over samples, never the
    (m, n) block) for the Kronecker family's (S, m₁, …, m_d), in as many
    slices of S as keep the (S, m / m_d, n) intermediate within
    ``iterative.SAMPLER_CHUNK_BYTES``."""
    from vggp_tpu_torch.models.iterative import _in_chunks, _kufT_w

    if diff.dim() == 2:
        return diff @ common.khatri_rao_all(blocks)
    row_bytes = (diff[0].numel() // blocks[-1].shape[0]) * blocks[0].shape[1] * diff.element_size()
    return _in_chunks(lambda part: _kufT_w(blocks, part), diff, row_bytes)


def _collapsed_w_q(LB: torch.Tensor, c: torch.Tensor, Z: torch.Tensor) -> torch.Tensor:
    """S draws of the collapsed-optimal q*(w), L_B⁻ᵀ(c + z) → (S, m)."""
    return tri_solve(LB, c[:, None] + Z.T, trans=True).T


@highest_precision
def pathwise_posterior(spec, params, gen: torch.Generator, xstar: torch.Tensor,
                       n_samples: int = 8, n_features: int = 1024) -> torch.Tensor:
    """Coherent posterior function draws of an SVGP at ``xstar`` → (S, n):
    f_s = f_prior,s + a(x)ᵀ(w_q,s − F⁻¹u_prior,s), a(x) the per-axis
    whitened blocks (never joined for the Kronecker family); a coregion
    spec draws chol(B)-mixed path bundles. Draws come from ``gen``."""
    if xstar.dim() == 1:
        xstar = xstar[:, None]
    chols = common.axis_chol_kuu(spec, params)
    blocks = common.axis_whitened_kuf(spec, params, chols, xstar)
    co, _ = _coregion_split(spec)

    def one():
        f, u = _path_and_u(gen, spec, params, n_features, xstar, co)
        return f, u, normal(gen, _z_shape(spec), f)

    f_prior, U, Z = _stack_draws(n_samples, one)
    diff = _svgp_diff_sample(spec, params, _whiten_samples(U, chols), Z)
    return f_prior + _apply_blocks(spec, diff, blocks) + common.mean_fn(spec, params, xstar)


@highest_precision
def pathwise_posterior_with_grads(spec, params, gen: torch.Generator, xstar: torch.Tensor,
                                  grad_axes=None, n_samples: int = 8,
                                  n_features: int = 1024) -> torch.Tensor:
    """Joint draws of (f, ∂f for each entry of ``grad_axes``) of an SVGP at
    ``xstar`` → (S, 1 + len(grad_axes), n): every row of a sample rides the
    same prior path and the same Matheron residual. An entry is an axis j
    (∂/∂x_j) or a per-axis order tuple, e.g. (2, 0) for ∂²/∂x² and (1, 1)
    for ∂²/∂x∂y; first derivatives need Matérn ≥ 3/2 or the RBF on that
    axis, second ones Matérn ≥ 5/2 or the RBF. The mean goes on row 0.

    Matérn-3/2 path frequencies are Student-t₃ draws with an infinite 4th
    moment, so one sample's gradient rows are heavy-tailed at any finite
    ``n_features`` (``sampling.py:757-763``)."""
    if xstar.dim() == 1:
        xstar = xstar[:, None]
    if grad_axes is None:
        grad_axes = tuple(range(spec.ndim))
    orders_list = [common.normalize_deriv_orders(spec, e) for e in grad_axes]
    chols = common.axis_chol_kuu(spec, params)
    blocks = common.axis_whitened_kuf(spec, params, chols, xstar)
    dblocks = [common.axis_whitened_deriv_kuf(spec, params, chols, xstar, o)
               for o in orders_list]

    def one():
        om, ph, amp = prior_paths(gen, spec, params, n_features)
        f = eval_path(om, ph, amp, xstar)
        u = prior_inducing_sample(om, ph, amp, spec, params)
        z = normal(gen, _z_shape(spec), f)
        return (f, u, z, *(eval_path_deriv(om, ph, amp, xstar, o) for o in orders_list))

    f_prior, U, Z, *g_prior = _stack_draws(n_samples, one)
    diff = _svgp_diff_sample(spec, params, _whiten_samples(U, chols), Z)
    rows = [f_prior + _apply_blocks(spec, diff, blocks) + common.mean_fn(spec, params, xstar)]
    rows += [g + _apply_blocks(spec, diff, db) for g, db in zip(g_prior, dblocks)]
    return torch.stack(rows, dim=1)


@highest_precision
def pathwise_posterior_collapsed(spec, params, gen: torch.Generator, X: torch.Tensor,
                                 y: torch.Tensor, xstar: torch.Tensor, n_samples: int = 8,
                                 n_features: int = 1024) -> torch.Tensor:
    """Coherent draws from the collapsed-optimal posterior of an ``SGPRSpec``
    model (any feature family, any ndim, the coregion axis) → (S, n*):
    w_q = L_B⁻ᵀ(c + z) from the factored state, then the SVGP's update."""
    if xstar.dim() == 1:
        xstar = xstar[:, None]
    chols, _, LB, c, _ = common.factored_state(spec, params, X, y)
    a = common.khatri_rao_all(common.axis_whitened_kuf(spec, params, chols, xstar))
    m = a.shape[0]
    co, _ = _coregion_split(spec)

    def one():
        f, u = _path_and_u(gen, spec, params, n_features, xstar, co)
        return f, u, normal(gen, (m,), f)

    f_prior, U, Z = _stack_draws(n_samples, one)
    W = _whiten_samples(U, chols).reshape(n_samples, -1)
    return f_prior + (_collapsed_w_q(LB, c, Z) - W) @ a + common.mean_fn(spec, params, xstar)


@highest_precision
def pathwise_posterior_collapsed_with_grads(spec, params, gen: torch.Generator,
                                            X: torch.Tensor, y: torch.Tensor,
                                            xstar: torch.Tensor, grad_axes=None,
                                            n_samples: int = 8,
                                            n_features: int = 1024) -> torch.Tensor:
    """Joint (f, derivative rows) draws from the collapsed-optimal posterior
    of an ``SGPRSpec`` model → (S, 1 + len(grad_axes), n*); ``grad_axes`` as
    in :func:`pathwise_posterior_with_grads`, the mean on row 0."""
    if xstar.dim() == 1:
        xstar = xstar[:, None]
    if grad_axes is None:
        grad_axes = tuple(range(spec.ndim))
    orders_list = [common.normalize_deriv_orders(spec, e) for e in grad_axes]
    chols, _, LB, c, _ = common.factored_state(spec, params, X, y)
    a = common.khatri_rao_all(common.axis_whitened_kuf(spec, params, chols, xstar))
    da = [common.khatri_rao_all(common.axis_whitened_deriv_kuf(spec, params, chols, xstar, o))
          for o in orders_list]
    m = a.shape[0]

    def one():
        om, ph, amp = prior_paths(gen, spec, params, n_features)
        f = eval_path(om, ph, amp, xstar)
        u = prior_inducing_sample(om, ph, amp, spec, params)
        z = normal(gen, (m,), f)
        return (f, u, z, *(eval_path_deriv(om, ph, amp, xstar, o) for o in orders_list))

    f_prior, U, Z, *g_prior = _stack_draws(n_samples, one)
    diff = _collapsed_w_q(LB, c, Z) - _whiten_samples(U, chols).reshape(n_samples, -1)
    rows = [f_prior + diff @ a + common.mean_fn(spec, params, xstar)]
    rows += [g + diff @ dai for g, dai in zip(g_prior, da)]
    return torch.stack(rows, dim=1)


@highest_precision
def pathwise_posterior_free(spec, params, gen: torch.Generator, X: torch.Tensor,
                            y: torch.Tensor, xstar: torch.Tensor, n_samples: int = 8,
                            n_features: int = 1024) -> torch.Tensor:
    """Coherent draws for the free-inducing-point ``FreeSVGPSpec`` model
    (collapsed-optimal q; the inducing functionals are point values of the
    path at the trained Z) → (S, n*). No mean is added, as in the JAX
    package."""
    from vggp_tpu_torch.models import freesvgp

    if xstar.dim() == 1:
        xstar = xstar[:, None]
    chol, _, LB, c, _ = freesvgp._factored_state(spec, params, X, y)
    a = chol.whiten(freesvgp._hadamard_gram(spec, params, params["z"], xstar))
    m = a.shape[0]

    def one():
        om, ph, amp = prior_paths(gen, spec, params, n_features)
        f = eval_path(om, ph, amp, xstar)
        return f, eval_path(om, ph, amp, params["z"]), normal(gen, (m,), f)

    f_prior, U, Z = _stack_draws(n_samples, one)
    return f_prior + (_collapsed_w_q(LB, c, Z) - chol.whiten(U.T).T) @ a


@highest_precision
def pathwise_posterior_exact(spec, params, gen: torch.Generator, X: torch.Tensor,
                             y: torch.Tensor, xstar: torch.Tensor, n_samples: int = 8,
                             n_features: int = 1024) -> torch.Tensor:
    """Coherent draws from the exact GP posterior by Matheron's rule against
    the data (Wilson et al. 2020, eq. 7) → (S, n*); ε_s at the per-point
    (per-output) noise, the S solves as the columns of one."""
    from vggp_tpu_torch.models import exact

    if X.dim() == 1:
        X = X[:, None]
    if xstar.dim() == 1:
        xstar = xstar[:, None]
    y = y.reshape(-1) - common.mean_fn(spec, params, X)
    L = exact._chol_ky(spec, params, X)
    ksx = common.gram_full(spec, params, xstar, X)
    sigma = torch.sqrt(common.obs_noise(spec, params, X))
    co, _ = _coregion_split(spec)

    def one():
        if co is None:
            om, ph, amp = prior_paths(gen, spec, params, n_features)
            f_star, f_X = eval_path(om, ph, amp, xstar), eval_path(om, ph, amp, X)
        else:
            om, ph, amp, LBm, _ = prior_paths_multioutput(gen, spec, params, n_features)
            f_star = eval_path_multioutput(om, ph, amp, LBm, co, xstar)
            f_X = eval_path_multioutput(om, ph, amp, LBm, co, X)
        eps = sigma * normal(gen, f_X.shape, f_X)
        return f_star, y - f_X - eps

    f_star, resid = _stack_draws(n_samples, one)
    alpha = solve_psd(L, resid.T)                       # (n, S)
    return f_star + (ksx @ alpha).T + common.mean_fn(spec, params, xstar)


@highest_precision
def pathwise_posterior_additive(spec, params, gen: torch.Generator, X: torch.Tensor,
                                y: torch.Tensor, xstar: torch.Tensor, n_samples: int = 8,
                                n_features: int = 1024) -> torch.Tensor:
    """Coherent draws for the additive model (``AdditiveSGPRSpec``) →
    (S, n*): the prior path is a sum of independent 1-D paths, one a
    component, each drawing its own frequencies and phases; the inducing
    functionals are each component's, stacked as the block-diagonal Kuu.
    No mean is added, as in the JAX package."""
    from vggp_tpu_torch.models import additive

    if xstar.dim() == 1:
        xstar = xstar[:, None]
    d = spec.ndim
    chols, _, LB, c, _ = additive._factored_state(spec, params, X, y)
    a = torch.cat(common.axis_whitened_kuf(spec, params, chols, xstar), dim=0)
    m = a.shape[0]

    def one():
        f = torch.zeros((xstar.shape[0],), dtype=a.dtype, device=a.device)
        us = []
        for i in range(d):
            p_ax = common.axis_params(params, i)
            om = sample_frequencies(gen, spec.kinds[i], p_ax["lengthscale"], n_features)
            ph = _phases(gen, n_features, om)
            amp = torch.sqrt(2.0 * p_ax["variance"] / n_features)
            f = f + eval_path(om[None, :], ph, amp, xstar[:, i:i + 1])
            factor = _axis_factor(spec.features[i], spec.kinds[i], p_ax, om)
            us.append(_accumulate_factors(ph, amp, [factor]))
        return (f, *us, normal(gen, (m,), a))

    f_prior, *U, Z = _stack_draws(n_samples, one)
    W = torch.cat([chols[i].whiten(U[i].T).T for i in range(d)], dim=1)
    return f_prior + (_collapsed_w_q(LB, c, Z) - W) @ a


@highest_precision
def pathwise_posterior_sum(spec, params, gen: torch.Generator, X: torch.Tensor,
                           y: torch.Tensor, xstar: torch.Tensor, n_samples: int = 8,
                           n_features: int = 1024) -> torch.Tensor:
    """Coherent draws for the sum-of-separable-kernels model
    (``SumSGPRSpec``) → (S, n*): the prior path is a sum of independent
    per-component paths (coregion components through chol(B)-mixed
    bundles), the inducing functionals stacked blockwise."""
    from vggp_tpu_torch.models import sum as msum

    if xstar.dim() == 1:
        xstar = xstar[:, None]
    chols, _, LB, c, _ = msum._factored_state(spec, params, X, y)
    comps = [(comp, msum._comp_params(params, q)) for q, comp in enumerate(spec.components)]
    a = torch.cat([common.khatri_rao_all(common.axis_whitened_kuf(comp, cp, chols[q], xstar))
                   for q, (comp, cp) in enumerate(comps)], dim=0)
    m = a.shape[0]

    def one():
        f = torch.zeros((xstar.shape[0],), dtype=a.dtype, device=a.device)
        us = []
        for comp, cp in comps:
            fq, uq = _path_and_u(gen, comp, cp, n_features, xstar, _coregion_split(comp)[0])
            f = f + fq
            us.append(uq)
        return (f, *us, normal(gen, (m,), a))

    f_prior, *U, Z = _stack_draws(n_samples, one)
    W = torch.cat([_whiten_samples(U[q], chols[q]).reshape(n_samples, -1)
                   for q in range(len(comps))], dim=1)
    return f_prior + (_collapsed_w_q(LB, c, Z) - W) @ a + common.mean_fn(spec, params, xstar)


def pathwise(spec, params, gen: torch.Generator, xstar: torch.Tensor, data=None,
             n_samples: int = 8, n_features: int = 1024) -> torch.Tensor:
    """Coherent posterior draws for any model spec, dispatched on its type.

    ``data=(X, y)`` is required for the collapsed and exact families (their
    posterior is a function of the data); the SVGP ignores it.
    """
    from vggp_tpu_torch.models.additive import AdditiveSGPRSpec
    from vggp_tpu_torch.models.exact import ExactGPSpec
    from vggp_tpu_torch.models.freesvgp import FreeSVGPSpec
    from vggp_tpu_torch.models.sgpr import SGPRSpec
    from vggp_tpu_torch.models.sum import SumSGPRSpec
    from vggp_tpu_torch.models.svgp import SVGPSpec

    if isinstance(spec, SVGPSpec):
        return pathwise_posterior(spec, params, gen, xstar, n_samples=n_samples,
                                  n_features=n_features)
    if data is None:
        raise ValueError(f"{type(spec).__name__} needs data=(X, y) to sample "
                         "its (collapsed/exact) posterior")
    X, y = data
    if isinstance(spec, SGPRSpec):
        fn = pathwise_posterior_collapsed
    elif isinstance(spec, FreeSVGPSpec):
        fn = pathwise_posterior_free
    elif isinstance(spec, ExactGPSpec):
        fn = pathwise_posterior_exact
    elif isinstance(spec, AdditiveSGPRSpec):
        fn = pathwise_posterior_additive
    elif isinstance(spec, SumSGPRSpec):
        fn = pathwise_posterior_sum
    else:
        raise NotImplementedError(type(spec).__name__)
    return fn(spec, params, gen, X, y, xstar, n_samples=n_samples, n_features=n_features)


# --------------------------------------------------------------------------- #
# draws of the gridded product v (``sampling.py:1141-1227``): both u and the
# cell integrals v of a cosine path are exact per-axis integrals, so
#   v_s = v_prior,s + R (w_q,s − F⁻¹ u_prior,s),   R_i = Kvu_i F_i⁻ᵀ,
# draws the exact integral functionals, with no lattice anywhere.
# --------------------------------------------------------------------------- #


@highest_precision
def pathwise_q_v(spec, params, gen: torch.Generator, grid_axes, n_samples: int = 8,
                 n_features: int = 1024, data=None) -> torch.Tensor:
    """Coherent joint draws of the gridded product v → (S, g), flat
    row-major (the ``numpy.kron`` order of ``q_v``), for the ``SVGPSpec``
    (either variational family) and the collapsed ``SGPRSpec`` (pass
    ``data=(X, y)``). A learned mean adds its cell integrals
    (``common.grid_mean``, per output on a coregion axis), as ``q_v`` does,
    and a coregion spec draws chol(B)-mixed path bundles (its grid's
    output axis the model's ``OutputFeature``). Both depart from the JAX
    package, whose draws leave the mean out and which raises on a coregion
    axis."""
    from vggp_tpu_torch.models.iterative import _along_axes
    from vggp_tpu_torch.models.sgpr import SGPRSpec
    from vggp_tpu_torch.models.svgp import SVGPSpec

    collapsed = isinstance(spec, SGPRSpec)
    if collapsed:
        if data is None:
            raise ValueError("SGPRSpec needs data=(X, y) to sample q(v)")
        X, y = data
        chols, _, LB, c, _ = common.factored_state(spec, params, X, y)
    elif isinstance(spec, SVGPSpec):
        chols = common.axis_chol_kuu(spec, params)
    else:
        raise NotImplementedError(
            f"pathwise_q_v supports SVGPSpec and SGPRSpec; got "
            f"{type(spec).__name__} (use sampling.pathwise for function-"
            "space draws of the other families)")
    kvu_blocks = common.grid_kvu(spec, params, grid_axes)
    r_blocks = tuple(chols[i].whiten(kvu_blocks[i].T).T for i in range(spec.ndim))
    m = math.prod(b.shape[1] for b in r_blocks)
    z_shape = (m,) if collapsed else _z_shape(spec)

    co, _ = _coregion_split(spec)

    def one():
        if co is None:
            om, ph, amp = prior_paths(gen, spec, params, n_features)
            v = prior_grid_integral_sample(om, ph, amp, grid_axes)
            u = prior_inducing_sample(om, ph, amp, spec, params)
        else:
            om, ph, amp, LBm, _ = prior_paths_multioutput(gen, spec, params, n_features)
            v = prior_grid_integral_sample_multioutput(om, ph, amp, LBm, co, grid_axes)
            u = prior_inducing_sample_multioutput(om, ph, amp, LBm, co, spec, params)
        return v, u, normal(gen, z_shape, v)

    V, U, Z = _stack_draws(n_samples, one)
    W = _whiten_samples(U, chols)
    if collapsed:
        diff = (_collapsed_w_q(LB, c, Z) - W.reshape(n_samples, -1)).reshape(W.shape)
    else:
        diff = _svgp_diff_sample(spec, params, W, Z).reshape(W.shape)
    corr = _along_axes(diff, [lambda v, R=R: R @ v for R in r_blocks])
    return (V.reshape(n_samples, -1) + corr.reshape(n_samples, -1)
            + common.grid_mean(spec, params, grid_axes))
