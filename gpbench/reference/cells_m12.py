"""B0 cell features of the Matérn-1/2 kernel k(r) = σ²·e^{−|r|/ℓ} on one axis,
in closed form and dense: the cell-cell Gram Kuu, the cell-point Kuf and
the prior variance.

For cells [a_i, b_i] of width δ_i and a point x:

- Kuf[i, x] = ∫_{a_i}^{b_i} k(x − t) dt: outside the cell
  σ²ℓ·e^{−g/ℓ}·(1 − e^{−δ_i/ℓ}), g the distance to the nearer edge; inside
  σ²ℓ·(2 − e^{−(x−a_i)/ℓ} − e^{−(b_i−x)/ℓ});
- Kuu[i, j] = ∬ k(s − t) over cells i and j: for two cells apart by a gap
  g_ij ≥ 0, σ²ℓ²(1 − e^{−δ_i/ℓ})(1 − e^{−δ_j/ℓ})e^{−g_ij/ℓ}; on the
  diagonal 2σ²ℓ²(e^{−δ_i/ℓ} − 1 + δ_i/ℓ).

Each is written without cancellation (``expm1``, and a series for
e^{−d} − 1 + d at small d), so that it is as sound in float32 as in float64.
"""

from __future__ import annotations

import torch


def expm1mx(d: torch.Tensor) -> torch.Tensor:
    """e^{−d} − 1 + d for d ≥ 0: a series below d = 0.1 (six terms, error
    below d⁸/8! relative to d²/2, under 1e-12 there), else directly."""
    small = d < 0.1
    ds = torch.where(small, d, torch.zeros_like(d))
    series = ds * ds * (0.5 - ds * (1.0 / 6 - ds * (1.0 / 24 - ds * (1.0 / 120 - ds * (
        1.0 / 720 - ds / 5040)))))
    return torch.where(small, series, torch.expm1(-d) + d)


def kuu(mesh: torch.Tensor, variance, lengthscale) -> torch.Tensor:
    """(m, m) Gram of the cells of ``mesh`` (m + 1 edges)."""
    a, b = mesh[:-1], mesh[1:]
    d = (b - a) / lengthscale
    one_minus = -torch.expm1(-d)
    gap = torch.clamp(torch.maximum(a[None, :] - b[:, None], a[:, None] - b[None, :]), min=0.0)
    off = one_minus[:, None] * one_minus[None, :] * torch.exp(-gap / lengthscale)
    eye = torch.eye(a.shape[0], dtype=torch.bool, device=mesh.device)
    gram = torch.where(eye, (2.0 * expm1mx(d))[:, None].expand_as(off), off)
    return variance * lengthscale * lengthscale * gram


def kuf(mesh: torch.Tensor, x: torch.Tensor, variance, lengthscale) -> torch.Tensor:
    """(m, n) covariance of the cells of ``mesh`` with f at the points ``x``."""
    a, b = mesh[:-1, None], mesh[1:, None]
    x = x[None, :]
    u = (x - a) / lengthscale            # ≥ 0 right of a
    w = (b - x) / lengthscale            # ≥ 0 left of b
    inside = (u >= 0) & (w >= 0)
    near = torch.minimum(torch.abs(u), torch.abs(w))
    out = torch.exp(-near) * (-torch.expm1(-(b - a) / lengthscale))
    u_in = torch.where(inside, u, torch.zeros_like(u))
    w_in = torch.where(inside, w, torch.zeros_like(w))
    val_in = -torch.expm1(-u_in) - torch.expm1(-w_in)
    return variance * lengthscale * torch.where(inside, val_in, out)


def jittered(k: torch.Tensor, rel_jitter: float) -> torch.Tensor:
    """K + rel·mean(diag K)·I: the configuration's relative jitter."""
    scale = torch.mean(torch.diagonal(k)) * rel_jitter
    return k + scale * torch.eye(k.shape[0], dtype=k.dtype, device=k.device)


def inv_chol(k: torch.Tensor) -> torch.Tensor:
    """F⁻¹ for K = F·Fᵀ, F lower-triangular: a dense Cholesky and a
    triangular solve against the identity."""
    f = torch.linalg.cholesky(k)
    eye = torch.eye(k.shape[0], dtype=k.dtype, device=k.device)
    return torch.linalg.solve_triangular(f, eye, upper=False)
