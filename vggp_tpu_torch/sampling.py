"""Pathwise sampling, its prior-path layer (port of ``vggp_tpu/sampling.py:49-656``).

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
the same draws. The Matheron samplers over these paths are in
``models.iterative``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from vggp_tpu_torch import kernels
from vggp_tpu_torch.features import (B1SplineFeature, CellIntegralFeature, FourierFeature,
                                     PointFeature, SplineRKHSFeature)
from vggp_tpu_torch.models import common

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
