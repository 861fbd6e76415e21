"""Kernel primitives of the port (of ``vggp_tpu/kernels.py``): the kinds,
k(r), the Matérn decay rate, dense 1-D Grams and the separable 2-D product
and their diagonals, the per-axis Gram dispatch, the stable k(0) − k(r), the
derivative kernels of the gradient heads, and the spectral densities and
Markov-state constants behind the VFF and spline-RKHS Kuu closed forms, and
the coregion axis of the multi-output (ICM) models."""

from __future__ import annotations

import math
from typing import Dict

import torch

from vggp_tpu_torch.ops.stablemath import expm1mx, expm1s

KINDS = ("matern12", "matern32", "matern52", "rbf")
STATIONARY_KINDS = KINDS

SQRT3 = math.sqrt(3.0)
SQRT5 = math.sqrt(5.0)


def validate_kind(kind: str) -> str:
    if kind not in KINDS:
        raise ValueError(f"unknown kernel kind {kind!r}; expected one of {KINDS}")
    return kind


def k_r(kind: str, r: torch.Tensor, variance, lengthscale) -> torch.Tensor:
    """k(r) for nonnegative distances ``r``."""
    if kind == "matern12":
        return variance * torch.exp(-r / lengthscale)
    if kind == "matern32":
        z = SQRT3 * r / lengthscale
        return variance * (1.0 + z) * torch.exp(-z)
    if kind == "matern52":
        z = SQRT5 * r / lengthscale
        return variance * (1.0 + z + z * z / 3.0) * torch.exp(-z)
    if kind == "rbf":
        z = r / lengthscale
        return variance * torch.exp(-0.5 * z * z)
    raise ValueError(kind)


def lam(kind: str, lengthscale):
    """Matérn decay rate λ."""
    if kind == "matern12":
        return 1.0 / lengthscale
    if kind == "matern32":
        return SQRT3 / lengthscale
    if kind == "matern52":
        return SQRT5 / lengthscale
    raise ValueError(f"lambda undefined for {kind}")


# Markov (state-space) order p of each Matérn kernel: S(ω) = c/(λ² + ω²)^p,
# the state (f, f′, …, f^{(p−1)}).
MARKOV_ORDER = {"matern12": 1, "matern32": 2, "matern52": 3}


def white_noise_intensity(kind: str, variance, lengthscale):
    """c of S(ω) = c/(λ² + ω²)^p, the driving white-noise intensity of the
    Markov representation (the numerators of :func:`spectral_density`)."""
    l_ = lam(kind, lengthscale)
    p = MARKOV_ORDER[kind]
    if p == 1:
        return 2.0 * variance * l_
    if p == 2:
        return 4.0 * variance * l_ ** 3
    return (16.0 / 3.0) * variance * l_ ** 5


def p0_inv_rows(kind: str, variance, lengthscale):
    """P₀⁻¹ of the stationary Markov state, as a (p, p) nested tuple; its
    zeros stay Python floats so a consumer can skip them. P₀ is σ² for
    p = 1, diag(σ², σ²λ²) for p = 2 and σ²·[[1, 0, −λ²/3], [0, λ²/3, 0],
    [−λ²/3, 0, λ⁴]] for p = 3."""
    var = variance
    l_ = lam(kind, lengthscale)
    p = MARKOV_ORDER[kind]
    if p == 1:
        return ((1.0 / var,),)
    if p == 2:
        return ((1.0 / var, 0.0), (0.0, 1.0 / (var * l_ ** 2)))
    return ((9.0 / (8.0 * var), 0.0, 3.0 / (8.0 * var * l_ ** 2)),
            (0.0, 3.0 / (var * l_ ** 2), 0.0),
            (3.0 / (8.0 * var * l_ ** 2), 0.0, 9.0 / (8.0 * var * l_ ** 4)))


def spectral_density(kind: str, omega: torch.Tensor, variance, lengthscale) -> torch.Tensor:
    """Spectral density S(ω): 2σ²λ/(λ² + ω²) for Matérn-1/2, 4σ²λ³/(λ² + ω²)²
    and (16/3)σ²λ⁵/(λ² + ω²)³ for 3/2 and 5/2, σ²ℓ√(2π)e^{−(ℓω)²/2} for
    the RBF."""
    if kind == "rbf":
        return variance * lengthscale * math.sqrt(2.0 * math.pi) * torch.exp(
            -0.5 * (lengthscale * omega) ** 2)
    l_ = lam(kind, lengthscale)
    return white_noise_intensity(kind, variance, lengthscale) / (
        (l_ ** 2 + omega ** 2) ** MARKOV_ORDER[kind])


def kdiff0(kind: str, r: torch.Tensor, variance, lengthscale) -> torch.Tensor:
    """k(0) − k(r), cancellation-free for r ≪ ℓ (every term O(r²) or
    smaller, where the naive difference loses (ℓ/r)² relative digits in
    float32)."""
    z = torch.abs(r) / lengthscale
    if kind == "matern12":
        return -variance * expm1s(-z)
    if kind == "matern32":
        z = SQRT3 * z
        return -variance * (expm1mx(-z) + z * expm1s(-z))
    if kind == "matern52":
        z = SQRT5 * z
        return -variance * (expm1mx(-z) + z * expm1s(-z) + (z * z / 3.0) * torch.exp(-z))
    if kind == "rbf":
        return -variance * expm1s(-0.5 * z * z)
    raise ValueError(kind)


def gram_1d(kind: str, x1: torch.Tensor, x2: torch.Tensor, variance,
            lengthscale) -> torch.Tensor:
    """Dense Gram K[i, j] = k(|x1_i − x2_j|) for 1-D inputs.

    |d| is taken as ``where(d >= 0, d, −d)``: its derivative at d = 0 is +1,
    as ``jnp.abs``'s in the JAX package (``torch.abs`` takes 0 there). A
    learned inducing point that lands exactly on a data point (an Adam step
    of ±lr from a point on a uniform grid does) then steps as in JAX."""
    d = x1.reshape(-1)[:, None] - x2.reshape(-1)[None, :]
    return k_r(kind, torch.where(d >= 0, d, -d), variance, lengthscale)


def gram_product_2d(kinds: tuple, x1: torch.Tensor, x2: torch.Tensor, params1: Dict,
                    params2: Dict) -> torch.Tensor:
    """Separable product kernel k((s, t), (s′, t′)) = k1(s, s′)·k2(t, t′) on
    (n, 2) inputs: the elementwise product of two 1-D Grams."""
    k1 = gram_1d(kinds[0], x1[:, 0], x2[:, 0], params1["variance"], params1["lengthscale"])
    k2 = gram_1d(kinds[1], x1[:, 1], x2[:, 1], params2["variance"], params2["lengthscale"])
    return k1 * k2


def kdiag_1d(kind: str, x: torch.Tensor, variance, lengthscale) -> torch.Tensor:
    """diag(K(x, x)): the constant ``variance`` of a stationary kernel."""
    n = x.reshape(-1).shape[0]
    return torch.ones(n, dtype=x.dtype, device=x.device) * variance


def kdiag_product_2d(kinds: tuple, x: torch.Tensor, params1: Dict, params2: Dict) -> torch.Tensor:
    """diag of :func:`gram_product_2d`: the product of the two variances."""
    one = torch.ones(x.shape[0], dtype=x.dtype, device=x.device)
    return one * (params1["variance"] * params2["variance"])


# The multi-output (ICM) coregion axis (``kernels.py:291-366``): a discrete
# output axis whose Gram over the output indices is B = W Wᵀ + diag(κ), so
# K((x, p), (x', p')) = k(x, x')·B[p, p'] is one more Kronecker axis.

COREGION_KIND = "coregion"


def coregion_b(p: Dict) -> torch.Tensor:
    """B = W Wᵀ + diag(κ), the (P, P) ICM coregionalization matrix."""
    W = p["w"]
    return W @ W.T + torch.diag(p["kappa"])


def coregion_b_diag(p: Dict) -> torch.Tensor:
    """diag(B) = Σ_r W[:, r]² + κ without forming B."""
    return torch.sum(p["w"] ** 2, dim=1) + p["kappa"]


def _as_index(x: torch.Tensor, n_outputs=None):
    """The output index of each coordinate of the axis column: the nearest
    integer, ties to even (as ``jnp.round``). With ``n_outputs`` also the
    validity mask: a coordinate that is not within 1e-6 of an integer in
    [0, P) is invalid, and the callers poison what it gathers with NaN."""
    flat = x.reshape(-1)
    r = torch.round(flat)
    idx = r.to(torch.int64)
    if n_outputs is None:
        return idx
    valid = (torch.abs(flat - r) <= 1e-6) & (idx >= 0) & (idx < n_outputs)
    return idx, valid


def clip_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """An index that is safe to gather with from a length-``n`` axis, as
    XLA's gather reads it: a negative index wraps once, then every index is
    clipped into [0, n). Out of range it is an error on the CPU and a device
    assert on the card, which ends every later launch."""
    return torch.clamp(torch.where(idx < 0, idx + n, idx), 0, n - 1)


def _poison(values: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """NaN where the output index was invalid (the NaN branch is a
    constant, so the gradient stays finite)."""
    return torch.where(valid, values, torch.full_like(values, float("nan")))


def axis_gram(kind: str, p: Dict, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Per-axis dense Gram: :func:`gram_1d` for the stationary kinds, the
    gather B[p, p'] at the output indices for ``"coregion"``."""
    if kind == COREGION_KIND:
        B = coregion_b(p)
        P = B.shape[0]
        i1, v1 = _as_index(x1, P)
        i2, v2 = _as_index(x2, P)
        g = B[clip_index(i1, P)[:, None], clip_index(i2, P)[None, :]]
        return _poison(g, v1[:, None] & v2[None, :])
    return gram_1d(kind, x1, x2, p["variance"], p["lengthscale"])


def axis_kdiag(kind: str, p: Dict, x: torch.Tensor) -> torch.Tensor:
    """Per-axis diag K(x, x) (length-n vector): the stationary variance, or
    B[p, p] gathered at the output indices for ``"coregion"``."""
    if kind == COREGION_KIND:
        d = coregion_b_diag(p)
        idx, valid = _as_index(x, d.shape[0])
        return _poison(d[clip_index(idx, d.shape[0])], valid)
    n = x.reshape(-1).shape[0]
    v = p["variance"]
    return torch.ones((n,), dtype=v.dtype, device=v.device) * v


# Kernels whose GP is once mean-square differentiable: gradient observables
# ∂f/∂x exist only for these (−k″(0) = ∞ for Matérn-1/2). The
# second-derivative observables also need a finite k⁗(0).
DIFFERENTIABLE_KINDS = ("matern32", "matern52", "rbf")
TWICE_DIFFERENTIABLE_KINDS = ("matern52", "rbf")


def require_differentiable(kind: str) -> str:
    validate_kind(kind)
    if kind not in DIFFERENTIABLE_KINDS:
        raise ValueError(
            f"gradient observables need a once-differentiable GP; {kind!r} is "
            f"not (use one of {DIFFERENTIABLE_KINDS})")
    return kind


def require_twice_differentiable(kind: str) -> str:
    validate_kind(kind)
    if kind not in TWICE_DIFFERENTIABLE_KINDS:
        raise ValueError(
            f"second-derivative observables need a twice-differentiable GP; "
            f"{kind!r} is not (use one of {TWICE_DIFFERENTIABLE_KINDS})")
    return kind


def dk_dr(kind: str, r: torch.Tensor, variance, lengthscale) -> torch.Tensor:
    """k′(r) at the signed displacement r = x − x′ (odd in r):
    Cov(∂f(x), f(x′)) = k′(x − x′)."""
    require_differentiable(kind)
    if kind == "matern32":
        l_ = SQRT3 / lengthscale
        return -variance * l_ ** 2 * r * torch.exp(-l_ * torch.abs(r))
    if kind == "matern52":
        l_ = SQRT5 / lengthscale
        z = l_ * torch.abs(r)
        return -variance * (l_ ** 2 / 3.0) * r * (1.0 + z) * torch.exp(-z)
    z = r / lengthscale
    return -variance * (r / lengthscale ** 2) * torch.exp(-0.5 * z * z)


def neg_d2k_dr2(kind: str, r: torch.Tensor, variance, lengthscale) -> torch.Tensor:
    """−k″(r) at the signed displacement r: Cov(∂f(x), ∂f(x′)) = −k″(x − x′)."""
    require_differentiable(kind)
    if kind == "matern32":
        l_ = SQRT3 / lengthscale
        z = l_ * torch.abs(r)
        return variance * l_ ** 2 * (1.0 - z) * torch.exp(-z)
    if kind == "matern52":
        l_ = SQRT5 / lengthscale
        z = l_ * torch.abs(r)
        return variance * (l_ ** 2 / 3.0) * (1.0 + z - z * z) * torch.exp(-z)
    z = r / lengthscale
    return variance * (1.0 - z * z) * torch.exp(-0.5 * z * z) / lengthscale ** 2


def grad_variance(kind: str, variance, lengthscale):
    """Var[∂f/∂x] = −k″(0) of the 1-D axis process."""
    require_differentiable(kind)
    if kind == "matern32":
        return 3.0 * variance / lengthscale ** 2
    if kind == "matern52":
        return (5.0 / 3.0) * variance / lengthscale ** 2
    return variance / lengthscale ** 2


def dgram_1d(kind: str, x1: torch.Tensor, x2: torch.Tensor, variance,
             lengthscale) -> torch.Tensor:
    """D[i, j] = ∂/∂x1_i k(x1_i − x2_j) = Cov(∂f(x1_i), f(x2_j))."""
    return dk_dr(kind, x1.reshape(-1)[:, None] - x2.reshape(-1)[None, :], variance,
                 lengthscale)


def grad_gram_1d(kind: str, x1: torch.Tensor, x2: torch.Tensor, variance,
                 lengthscale) -> torch.Tensor:
    """G[i, j] = Cov(∂f(x1_i), ∂f(x2_j)) = −k″(x1_i − x2_j)."""
    return neg_d2k_dr2(kind, x1.reshape(-1)[:, None] - x2.reshape(-1)[None, :], variance,
                       lengthscale)
