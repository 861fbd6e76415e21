"""Observation models of the port (``vggp_tpu/likelihoods.py``): probit
classification, Poisson counts and Student-t robust regression beside the
Gaussian, through the variational expected log-likelihood

    ℓ_i = E_{q(f_i)}[log p(y_i | f_i)],   q(f_i) = N(μ_i, σ_i²),

in closed form where one exists (Gaussian, Poisson with the log link) and by
fixed-order Gauss–Hermite quadrature otherwise; the predictive transforms;
and draws of observations given latent draws.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

Params = Dict

# 64 nodes, as the JAX package takes: the Student-t log-density at a
# variance near 2 converges slowly (32 nodes leave 8e-5, 64 reach 7e-7).
GH_POINTS = 64

# physicists' Hermite nodes and weights, the weights normalized to sum to 1
_GH_X, _GH_W = np.polynomial.hermite.hermgauss(GH_POINTS)
_GH_WN = _GH_W / math.sqrt(math.pi)


def gauss_hermite(log_prob, y, mean, var):
    """E_{N(f|mean,var)}[log_prob(y, f)] by Gauss–Hermite quadrature.

    ``log_prob(y, f)`` must broadcast over a trailing quadrature axis.
    Shapes: y, mean, var are (n,) → returns (n,).
    """
    x = torch.as_tensor(_GH_X, dtype=mean.dtype, device=mean.device)
    w = torch.as_tensor(_GH_WN, dtype=mean.dtype, device=mean.device)
    f = mean[:, None] + torch.sqrt(2.0 * var)[:, None] * x[None, :]
    return log_prob(y[:, None], f) @ w


def _ell_gaussian(y, mean, var, params, opts):
    noise = params["noise"]
    return -0.5 * torch.log(2.0 * math.pi * noise) - ((y - mean) ** 2 + var) / (2.0 * noise)


def _ell_bernoulli_probit(y, mean, var, params, opts):
    """y ∈ {0, 1}, p(y=1|f) = Φ(f): quadrature over log Φ(±f)."""
    sign = 2.0 * y - 1.0
    return gauss_hermite(lambda s, f: torch.special.log_ndtr(s * f), sign, mean, var)


def _ell_poisson_log(y, mean, var, params, opts):
    """y ∈ ℕ, rate e^f: E[y f − e^f − log y!] = y μ − e^{μ + σ²/2} − log Γ(y+1)."""
    return y * mean - torch.exp(mean + 0.5 * var) - torch.lgamma(y + 1.0)


def _ell_student_t(y, mean, var, params, opts):
    """y | f ~ StudentT(ν, f, √noise); ν from ``opts`` (default 4), the
    trained ``noise`` the squared scale."""
    df = float(opts.get("df", 4.0))
    scale2 = params["noise"]
    const = math.lgamma((df + 1.0) / 2.0) - math.lgamma(df / 2.0)

    def logp(yy, f):
        z2 = (yy - f) ** 2 / scale2
        return (const - 0.5 * torch.log(math.pi * df * scale2)
                - 0.5 * (df + 1.0) * torch.log1p(z2 / df))

    return gauss_hermite(logp, y, mean, var)


EXPECTED_LOG_LIK = {
    "gaussian": _ell_gaussian,
    "bernoulli": _ell_bernoulli_probit,
    "poisson": _ell_poisson_log,
    "student_t": _ell_student_t,
}


def check_likelihood(name: str) -> None:
    if name not in EXPECTED_LOG_LIK:
        raise ValueError(f"unknown likelihood {name!r}; have {sorted(EXPECTED_LOG_LIK)}")


def expected_log_lik(name: str, y, mean, var, params, opts=()) -> torch.Tensor:
    check_likelihood(name)
    return EXPECTED_LOG_LIK[name](y, mean, var, params, dict(opts))


def predict_bernoulli(mean, var):
    """p(y*=1) = Φ(μ/√(1+σ²)), exact under the probit link."""
    return torch.special.ndtr(mean / torch.sqrt(1.0 + var))


def predict_poisson(mean, var):
    """(E[λ], Var[y]) under the log link: E[λ] = e^{μ+σ²/2},
    Var[y] = E[λ] + E[λ]²(e^{σ²} − 1)."""
    lam = torch.exp(mean + 0.5 * var)
    return lam, lam + lam * lam * torch.expm1(var)


def _student_t_draws(df: float, shape, dtype, device, generator) -> torch.Tensor:
    """Standard Student-t draws by Bailey's polar method: (u, v) uniform on
    the unit disc, w = u² + v², t = u·√(ν(w^{−2/ν} − 1)/w). Rejection runs
    until every entry has a point in the disc (accepted with p = π/4)."""
    n = math.prod(shape)
    out = torch.empty(n, dtype=dtype, device=device)
    todo = torch.arange(n, device=device)
    while todo.numel():
        uv = 2.0 * torch.rand((2, todo.numel()), dtype=dtype, device=device,
                              generator=generator) - 1.0
        w = uv[0] * uv[0] + uv[1] * uv[1]
        ok = (w > 0) & (w <= 1)
        u, w = uv[0][ok], w[ok]
        out[todo[ok]] = u * torch.sqrt(df * (w ** (-2.0 / df) - 1.0) / w)
        todo = todo[~ok]
    return out.reshape(shape)


def sample_observations(name: str, generator: torch.Generator, f_samples: torch.Tensor,
                        params=None, opts=()) -> torch.Tensor:
    """Draw y ~ p(y | f) elementwise over latent draws ``f_samples``, from
    ``generator`` (on the draws' device) in place of the JAX key:
    ``gaussian`` adds N(0, noise); ``bernoulli`` gives {0, 1} with p = Φ(f);
    ``poisson`` counts with λ = eᶠ; ``student_t`` adds √noise-scaled t_ν
    noise, ν from ``opts``. The draws follow the same laws as the JAX
    package's, not its bits."""
    check_likelihood(name)
    p = params or {}
    shape, dtype, device = f_samples.shape, f_samples.dtype, f_samples.device
    if name == "gaussian":
        z = torch.randn(shape, dtype=dtype, device=device, generator=generator)
        return f_samples + torch.sqrt(p["noise"]) * z
    if name == "bernoulli":
        u = torch.rand(shape, dtype=dtype, device=device, generator=generator)
        return (u < torch.special.ndtr(f_samples)).to(dtype)
    if name == "poisson":
        return torch.poisson(torch.exp(f_samples), generator=generator)
    df = float(dict(opts).get("df", 4.0))
    t = _student_t_draws(df, shape, dtype, device, generator)
    return f_samples + torch.sqrt(p["noise"]) * t
