"""Streaming assimilation: exact online updates of the whitened posterior
(port of ``vggp_tpu/streaming.py``).

In whitened coordinates (u = F w, q(w) = N(μ, S); ``models/svgp.py``) the
Gaussian-likelihood variational optimum is natural-parameter accumulation,
recursive least squares on the whitened features:

    Λ ← Λ + A diag(1/σ²) Aᵀ       η ← η + A (y/σ²)       A = F⁻¹Kuf  (m, n)
    μ* = Λ⁻¹ η                     S* = Λ⁻¹               Λ₀ = I, η₀ = 0

The state after any prefix of the stream is the optimal batch posterior of
all data seen so far: Λ is the collapsed model's B = I + AAᵀ/σ², however the
stream was chunked. Beside exact assimilation the state takes per-point
noise, exponential forgetting toward the prior (:func:`forget`), batches
under a non-conjugate likelihood (:func:`assimilate_natgrad`), a change of
hyperparameters (:func:`reanchor`) and hands its q(w) to every SVGP head
(:func:`to_params`), ``sampling.pathwise`` included.

A state is ``{"lam", "eta", "n_seen"}``, the JAX package's tree: a JAX state
crosses as numpy through ``convert.params_from_jax``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from vggp_tpu_torch import config
from vggp_tpu_torch.config import highest_precision
from vggp_tpu_torch.models import common
from vggp_tpu_torch.models.svgp import SVGPSpec, raw_from_chol
from vggp_tpu_torch.ops.chol import solve_psd, tri_solve
from vggp_tpu_torch.ops.kron import kron_dense

Params = Dict
State = Dict


def _check_family(spec: SVGPSpec) -> None:
    if spec.variational != "full":
        raise ValueError(
            "streaming assimilation maintains a dense whitened precision; "
            'use variational="full" (the kron family has no closed-form optimum)'
        )


def _check(spec: SVGPSpec) -> None:
    if spec.likelihood != "gaussian":
        raise ValueError(
            "exact streaming assimilation is the closed-form Gaussian-"
            f"likelihood update; got likelihood={spec.likelihood!r} (use "
            "assimilate_natgrad for non-conjugate observation models)"
        )
    _check_family(spec)


def init_state(spec: SVGPSpec, dtype=torch.float32, device=None) -> State:
    """A fresh stream state, the whitened prior: Λ = I, η = 0, on ``cuda``
    unless ``device`` is given."""
    _check_family(spec)
    device = config.resolve_device(device)
    m = spec.num_inducing
    return {
        "lam": torch.eye(m, dtype=dtype, device=device),
        "eta": torch.zeros((m,), dtype=dtype, device=device),
        "n_seen": torch.zeros((), dtype=dtype, device=device),
    }


def _whitened_a(spec: SVGPSpec, params: Params, X: torch.Tensor) -> torch.Tensor:
    """A = F⁻¹Kuf at the batch's points, the (m, n) Khatri–Rao block."""
    chols = common.axis_chol_kuu(spec, params)
    return common.khatri_rao_all(common.axis_whitened_kuf(spec, params, chols, X))


@highest_precision
def assimilate(spec: SVGPSpec, params: Params, state: State, X: torch.Tensor,
               y: torch.Tensor, noise: Optional[torch.Tensor] = None) -> State:
    """Fold one batch of observations into the stream state.

    ``noise`` is an optional per-point noise-variance vector (n,); the
    default is ``common.obs_noise`` (the scalar noise, or per output for a
    coregion spec). The returned state is the optimal whitened q of all data
    assimilated so far at these hyperparameters, however the stream was
    chunked or ordered. Its products run at full fp32 (no TF32): Λ's A·Aᵀ
    feeds every head downstream.
    """
    _check(spec)
    y = y.reshape(-1) - common.mean_fn(spec, params, X)
    a = _whitened_a(spec, params, X)
    inv_n = (1.0 / common.obs_noise(spec, params, X) if noise is None
             else 1.0 / noise.reshape(-1))
    aw = a * inv_n if inv_n.dim() == 0 else a * inv_n[None, :]
    return {
        "lam": state["lam"] + aw @ a.T,
        "eta": state["eta"] + aw @ y,
        "n_seen": state["n_seen"] + y.shape[0],
    }


def assimilate_scan(spec: SVGPSpec, params: Params, state: State, X_chunks: torch.Tensor,
                    y_chunks: torch.Tensor,
                    noise_chunks: Optional[torch.Tensor] = None) -> State:
    """Assimilate a (k, n, d) stream of k equal-size chunks in turn, the
    JAX package's ``lax.scan`` over :func:`assimilate`."""
    for i in range(X_chunks.shape[0]):
        noise = None if noise_chunks is None else noise_chunks[i]
        state = assimilate(spec, params, state, X_chunks[i], y_chunks[i], noise=noise)
    return state


@highest_precision
def assimilate_natgrad(spec: SVGPSpec, params: Params, state: State, X: torch.Tensor,
                       y: torch.Tensor, gamma: float = 0.5, n_inner: int = 4,
                       clip_h: bool = False) -> State:
    """Fold one batch into the stream state under a non-conjugate likelihood.

    Online conjugate-computation VI (Khan & Lin 2017): the batch contributes
    a Gaussian site in natural parameters from the gradients of the expected
    log-likelihood with respect to the mean parameters of q,

        ΔΛ = −2 Σᵢ hᵢ aᵢaᵢᵀ,   Δη = Σᵢ (gᵢ − 2 hᵢ mᵢ) aᵢ,
        gᵢ = ∂ℓᵢ/∂mᵢ,  hᵢ = ∂ℓᵢ/∂vᵢ   at  q(fᵢ) = N(mᵢ, vᵢ),

    damped toward the batch-conditional fixed point by ``n_inner`` site
    replacements at step ``gamma`` (the site is damped, not the state). For
    the Gaussian likelihood ``gamma=1, n_inner=1`` reproduces
    :func:`assimilate`. Log-concave likelihoods have hᵢ ≤ 0; for the
    Student-t ``clip_h=True`` floors hᵢ at 0 so that the site stays PSD.
    g and h are taken by autograd of ``likelihoods.expected_log_lik``.
    """
    _check_family(spec)
    from vggp_tpu_torch.likelihoods import expected_log_lik

    y = y.reshape(-1)
    a = _whitened_a(spec, params, X)
    m = a.shape[0]
    # q(f_i)'s variance is k_ff − ‖a‖² + aᵀSa; the first two terms do not
    # depend on q
    kff = common.kdiag(spec, params, X)
    var_gap = torch.clamp(kff - torch.sum(a * a, dim=0), min=0.0)
    site_lam = torch.zeros((m, m), dtype=a.dtype, device=a.device)
    site_eta = torch.zeros((m,), dtype=a.dtype, device=a.device)
    for _ in range(n_inner):
        cur = {"lam": state["lam"] + site_lam, "eta": state["eta"] + site_eta,
               "n_seen": state["n_seen"]}
        mu, Ls = _mu_and_chol_S(cur)
        mean_g = a.T @ mu
        # the likelihood sees f = m + g; the site's naturals live in g-space
        mean_f = mean_g + common.mean_fn(spec, params, X)
        sa = Ls.T @ a
        var = var_gap + torch.sum(sa * sa, dim=0)
        with torch.enable_grad():
            mf = mean_f.detach().requires_grad_(True)
            vf = var.detach().requires_grad_(True)
            ell = torch.sum(expected_log_lik(spec.likelihood, y, mf, vf, params,
                                             spec.likelihood_opts))
            g, h = torch.autograd.grad(ell, (mf, vf))
        if clip_h:
            h = torch.clamp(h, max=0.0)
        fresh_lam = -2.0 * (a * h[None, :]) @ a.T
        fresh_eta = a @ (g - 2.0 * h * mean_g)
        site_lam = (1.0 - gamma) * site_lam + gamma * fresh_lam
        site_eta = (1.0 - gamma) * site_eta + gamma * fresh_eta
    return {
        "lam": state["lam"] + 0.5 * (site_lam + site_lam.T),
        "eta": state["eta"] + site_eta,
        "n_seen": state["n_seen"] + y.shape[0],
    }


def forget(state: State, rho: float) -> State:
    """Discount past data toward the prior: Λ ← I + ρ(Λ − I), η ← ρη. The
    prior precision I stays, so Λ ⪰ I and the state stays a posterior."""
    lam = state["lam"]
    eye = torch.eye(lam.shape[0], dtype=lam.dtype, device=lam.device)
    return {
        "lam": eye + rho * (lam - eye),
        "eta": rho * state["eta"],
        "n_seen": rho * state["n_seen"],
    }


def _mu_and_chol_S(state: State) -> Tuple[torch.Tensor, torch.Tensor]:
    """(μ, chol(Λ⁻¹)) from one factorization of Λ, with no explicit inverse.

    With J the index reversal and G = chol(JΛJ), Λ⁻¹ = (JG⁻ᵀJ)(JG⁻¹J) and
    JG⁻ᵀJ is lower triangular, so chol(S) = flip(G⁻ᵀ). Inverting Λ and
    factoring the inverse loses the small eigenvalues of S under the
    inverse's entry error (about 100× worse float32 variances at
    cond(Λ) ≈ 1e7 in the JAX package).
    """
    lam = torch.flip(state["lam"], dims=(0, 1))
    lam = 0.5 * (lam + lam.T)
    # Absolute jitter: Λ ⪰ I fixes the scale, while mean(diag Λ) grows like
    # n/σ² with the stream, so a diagonal-relative floor would inflate the
    # unit prior eigenvalues with the stream's length.
    eps = 1e-12 if lam.dtype == torch.float64 else 1e-6
    G = torch.linalg.cholesky(lam + eps * torch.eye(lam.shape[0], dtype=lam.dtype,
                                                    device=lam.device))
    mu = torch.flip(solve_psd(G, torch.flip(state["eta"], dims=(0,))), dims=(0,))
    ginv = tri_solve(G, torch.eye(G.shape[0], dtype=G.dtype, device=G.device))
    return mu, torch.flip(ginv.T, dims=(0, 1))


@highest_precision
def to_q(state: State) -> Tuple[torch.Tensor, torch.Tensor]:
    """(μ, S) of the whitened posterior from the natural state."""
    mu, Ls = _mu_and_chol_S(state)
    return mu, Ls @ Ls.T


@highest_precision
def reanchor(spec: SVGPSpec, params_old: Params, params_new: Params, state: State) -> State:
    """Carry the stream state across a change of hyperparameters.

    The data's information, whitened against the old prior (u = F_old w),
    is re-expressed in the new whitening with T = F_old⁻¹ F_new (a Kronecker
    product of per-axis triangular solves):

        Λ' = I + Tᵀ (Λ − I) T          η' = Tᵀ η

    The prior swap is exact; the past batches' Kuf stay at the hypers they
    were assimilated under (Bui, Nguyen & Turner 2017).
    """
    _check_family(spec)
    chols_old = common.axis_chol_kuu(spec, params_old)
    chols_new = common.axis_chol_kuu(spec, params_new)
    ts = [chols_old[i].whiten(chols_new[i].F) for i in range(spec.ndim)]
    T = ts[0] if spec.ndim == 1 else kron_dense(ts)
    eye = torch.eye(T.shape[0], dtype=T.dtype, device=T.device)
    lam = eye + T.T @ ((state["lam"] - eye) @ T)
    return {
        "lam": 0.5 * (lam + lam.T),
        "eta": T.T @ state["eta"],
        "n_seen": state["n_seen"],
    }


@highest_precision
def to_params(spec: SVGPSpec, params: Params, state: State) -> Params:
    """The stream state's q(w) written into an SVGP parameter dict, for
    every SVGP head (``svgp.posterior``, ``svgp.q_v``, ``svgp.elbo``,
    ``sampling.pathwise``) as if that q had been trained."""
    _check_family(spec)
    mu, Ls = _mu_and_chol_S(state)
    p = dict(params)
    p["q"] = {"mu": mu, "raw_L": raw_from_chol(Ls)}
    return p
