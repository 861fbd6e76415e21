"""Hyperparameter posteriors and hyperparameter-marginalized prediction —
port of ``vggp_tpu/hyperpost.py``.

1. :func:`laplace` — a Gaussian N(θ̂, H⁻¹) over the unconstrained (softplus
   raw) hyperparameters, H the Hessian of the loss ``fit`` minimized, taken
   by ``torch.autograd.functional.hessian`` inside
   :func:`models.common.second_order` (the scalar-tangent whitening's
   backward is first-order only). The flat vector is ``train.ravel``'s, in
   ``ravel_pytree``'s leaf order.
2. :func:`sample_params` — constrained draws θ_s ~ N(θ̂, H⁻¹), every leaf
   with a leading (S,) axis.
3. :func:`predict_marginalized` — a predictive head over the draws, one call
   a draw (the JAX package ``vmap``s it), moment-matched as a mixture.
4. :func:`hmc_sample_params` — HMC in the Laplace-whitened coordinates, the
   chains one after another (JAX ``vmap``s them), the leapfrog a Python
   loop of one gradient each; the accept and the step-size adaptation stay
   on the device.

Random draws come from a ``torch.Generator`` through ``sampling.normal``
and ``sampling.uniform``, made in float64 on its device and cast.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from vggp_tpu_torch import sampling, train
from vggp_tpu_torch.models.common import Gaussian, second_order


class LaplaceState(NamedTuple):
    """Gaussian over unconstrained hyperparameters: θ_raw ~ N(mean, L Lᵀ)."""

    mean: torch.Tensor      # (p,) raw-space optimum, in train.ravel order
    chol_cov: torch.Tensor  # (p, p) a square root of the covariance
    logdet_h: torch.Tensor  # log|H|
    unravel: Callable       # (…, p) -> raw parameter tree


def _constrained(state: LaplaceState, raws: torch.Tensor):
    return train.constrain(state.unravel(raws))


def raw_hessian(loss_fn, params):
    """(H, flat, unravel): the Hessian of ``loss_fn(constrain(unravel(v)))``
    at the raw optimum ``flat`` (``train.ravel`` of ``unconstrain(params)``),
    by p reverse passes over a graph of the gradient, inside
    :func:`models.common.second_order` (the route whose second derivative
    is exact)."""
    raw = train.tree_map(lambda v: v.detach(), train.unconstrain(params))
    flat, unravel = train.ravel(raw)

    def flat_loss(v):
        return loss_fn(train.constrain(unravel(v)))

    with second_order():
        H = torch.autograd.functional.hessian(flat_loss, flat)
    return H, flat, unravel


def laplace(loss_fn, params, min_eig_rel: float = 1e-8) -> LaplaceState:
    """Laplace approximation at a fitted optimum.

    ``loss_fn(params)`` is the constrained-params scalar ``train.fit``
    minimized; the curvature is taken in the raw space. The saddle-free
    treatment of the JAX package: |eigenvalues| floored at ``min_eig_rel``
    of the spectral radius (a no-op on a clean positive float64 spectrum).
    ``chol_cov`` is V·w^−½ — a square root, not triangular. The (p, p)
    eigendecomposition runs on the CPU whatever the device: cuSOLVER's
    eigenvectors can take other signs than LAPACK's, and V's signs carry
    into every draw of :func:`sample_params`, so one generator seed gives
    the card and the CPU the same draws only through one LAPACK.
    """
    H, flat, unravel = raw_hessian(loss_fn, params)
    H = 0.5 * (H + H.T)
    w, V = (t.to(H.device) for t in torch.linalg.eigh(H.cpu()))
    w = torch.maximum(torch.abs(w), min_eig_rel * torch.max(torch.abs(w)))
    half = V * (1.0 / torch.sqrt(w))[None, :]
    return LaplaceState(mean=flat, chol_cov=half, logdet_h=torch.sum(torch.log(w)),
                        unravel=unravel)


def sample_params(state: LaplaceState, gen: torch.Generator, n_samples: int):
    """``n_samples`` constrained hyperparameter trees stacked on axis 0: the
    (S, p) standard normals of one draw from ``gen``, θ = mean + L·ε."""
    eps = sampling.normal(gen, (n_samples, state.mean.shape[0]), state.mean)
    return _constrained(state, state.mean[None, :] + eps @ state.chol_cov.T)


def mixture_moments(means: torch.Tensor, variances: torch.Tensor):
    """Moment-match an equal-weight Gaussian mixture along axis 0:
    mean = E_s μ_s; var = E_s σ_s² + Var_s μ_s (law of total variance)."""
    mean = torch.mean(means, dim=0)
    var = torch.mean(variances, dim=0) + torch.mean((means - mean[None]) ** 2, dim=0)
    return mean, var


def predict_marginalized_draws(predict_fn, draws) -> Gaussian:
    """Hyperparameter-marginalized predictive moments from explicit draws
    (e.g. ``HMCResult.draws``): ``predict_fn`` on each draw, the mixture
    moment-matched."""
    n = train.tree_leaves(draws)[0].shape[0]
    means, variances = [], []
    for s in range(n):
        g = predict_fn(train.tree_map(lambda v: v[s], draws))
        means.append(g.mean)
        variances.append(g.variance())
    mean, var = mixture_moments(torch.stack(means), torch.stack(variances))
    return Gaussian(mean=mean, var=var)


def predict_marginalized(predict_fn, state: LaplaceState, gen: torch.Generator,
                         n_samples: int = 64) -> Gaussian:
    """``predict_fn(params) -> Gaussian`` (a marginal head closed over its
    data) over ``n_samples`` Laplace draws, moment-matched: variances that
    include the hyperparameters' uncertainty."""
    return predict_marginalized_draws(predict_fn, sample_params(state, gen, n_samples))


class HMCResult(NamedTuple):
    """Stacked constrained hyperparameter draws and sampler diagnostics."""

    draws: dict               # constrained parameter tree, leaves (S, ...)
    accept_rate: torch.Tensor  # the post-warmup mean acceptance
    step_size: torch.Tensor    # (n_chains,) adapted leapfrog step sizes
    raw_draws: torch.Tensor    # (S, p) unconstrained draws


def hmc_sample_params(loss_fn, state: LaplaceState, gen: torch.Generator,
                      n_samples: int = 256, n_chains: int = 4, n_warmup: int = 128,
                      n_leapfrog: int = 16, target_accept: float = 0.8,
                      init_step: float = 0.25) -> HMCResult:
    """HMC on the raw hyperparameters in the Laplace-whitened coordinates w,
    θ_raw = μ + L·w, potential U(w) = loss_fn(constrain(μ + L·w)) (a flat
    prior on the raw space, as :func:`log_evidence_laplace`).

    Each chain draws w₀, then for each step the momentum, the ε jitter
    (uniform ±30%) and the accept uniform, in that order. A step whose
    energy is not finite is rejected. During warmup log ε moves by the
    Robbins–Monro gain t^−0.6 toward ``target_accept``; warmup draws are
    dropped. ``n_samples`` is the total over chains, rounded up to a
    multiple of ``n_chains``.
    """
    mean, L = state.mean, state.chol_cov
    p = mean.shape[0]
    per_chain = -(-n_samples // n_chains)

    def potential(w):
        return loss_fn(_constrained(state, mean + L @ w))

    def grad_u(w):
        w = w.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(potential(w), w)
        return g

    def leapfrog(w, mom, eps):
        mom = mom - 0.5 * eps * grad_u(w)
        for _ in range(n_leapfrog - 1):
            w = w + eps * mom
            mom = mom - eps * grad_u(w)
        w = w + eps * mom
        return w, mom - 0.5 * eps * grad_u(w)

    t = torch.arange(1, n_warmup + per_chain + 1, dtype=mean.dtype, device=mean.device)
    adapt = torch.where(t <= n_warmup, 1.0 / t ** 0.6, torch.zeros_like(t))
    chains, rates, steps = [], [], []
    for _ in range(n_chains):
        w = sampling.normal(gen, (p,), mean)
        with torch.no_grad():
            u_w = potential(w)
        log_eps = torch.log(torch.as_tensor(init_step, dtype=w.dtype, device=w.device))
        ws, accs = [], []
        for i in range(n_warmup + per_chain):
            mom = sampling.normal(gen, (p,), mean)
            eps = torch.exp(log_eps) * (0.7 + 0.6 * sampling.uniform(gen, (), mean))
            w_new, mom_new = leapfrog(w, mom, eps)
            with torch.no_grad():
                u_new = potential(w_new)
                log_accept = (u_w + 0.5 * torch.sum(mom ** 2)
                              - u_new - 0.5 * torch.sum(mom_new ** 2))
                log_accept = torch.where(torch.isfinite(log_accept), log_accept,
                                         torch.full_like(log_accept, -math.inf))
                accept_prob = torch.clamp(torch.exp(log_accept), max=1.0)
                take = torch.log(sampling.uniform(gen, (), w)) < log_accept
                w = torch.where(take, w_new, w)
                u_w = torch.where(take, u_new, u_w)
                log_eps = (log_eps + adapt[i] * (accept_prob - target_accept)).to(log_eps.dtype)
            ws.append(w)
            accs.append(accept_prob)
        chains.append(torch.stack(ws[n_warmup:]))
        rates.append(torch.mean(torch.stack(accs[n_warmup:])))
        steps.append(torch.exp(log_eps))
    raws = torch.cat(chains) @ L.T + mean[None, :]
    return HMCResult(draws=_constrained(state, raws), accept_rate=torch.mean(torch.stack(rates)),
                     step_size=torch.stack(steps), raw_draws=raws)


def log_evidence_laplace(loss_fn, params, state: LaplaceState) -> torch.Tensor:
    """Laplace estimate of the log evidence under a flat raw-space prior:
    log p(y) ≈ −loss(θ̂) + (p/2)·log 2π − ½ log|H|."""
    p = state.mean.shape[0]
    return -loss_fn(params) + 0.5 * p * math.log(2.0 * math.pi) - 0.5 * state.logdet_h
