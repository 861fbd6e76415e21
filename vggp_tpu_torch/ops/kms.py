"""Closed-form inverse Cholesky of the Matérn-1/2 cell-integral Kuu (port of
``vggp_tpu/ops/kms.py:47-263``).

The uniform-mesh B0 cell Gram decomposes exactly as γ·KMS(ρ) + η·I, so the
inverse Cholesky factor of the jittered Gram is built in O(m²) elementwise
work from the minors of a tridiagonal matrix, then refined by one
Newton–Schulz step against the analytic factor. The module docstring of the
JAX package derives every step; the code below keeps its order of operations
so that the two agree to roundoff in float64.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vggp_tpu_torch.config import matmul_precision
from vggp_tpu_torch.ops.stablemath import expm1mx, expm1s, sinhmx
from vggp_tpu_torch.ops.toeplitz import sym_toeplitz_dense
from vggp_tpu_torch.tracing import span


def _tridiag_coefficients(delta, variance, lengthscale, rel_jitter):
    """Scalar coefficients of C = γI + η_eff·W (0-d tensors)."""
    u = delta / lengthscale
    small = u < 1.0
    rho = torch.where(small, 1.0 + expm1s(-u), torch.exp(-torch.clamp(u, min=1.0)))
    omr = -expm1s(-u)                      # 1 − ρ, no cancellation
    s2 = -expm1s(-2.0 * u)                 # 1 − ρ²
    s = torch.sqrt(s2)
    c = variance * lengthscale * lengthscale

    diag0 = 2.0 * c * expm1mx(-u)          # Kuu diagonal
    us = torch.clamp(u, max=1.0)           # bound unselected-branch arguments
    es = expm1s(us)
    eta_s = -2.0 * c * sinhmx(us) + rel_jitter * diag0   # η_eff, u < 1 only
    # η_eff·ρ for u ≥ 1 via (sinh u − u)e^{−u} = −expm1(−2u)/2 − u·e^{−u}
    ul = torch.clamp(u, min=1.0)
    smrho_l = -0.5 * expm1s(-2.0 * ul) - ul * torch.exp(-ul)
    eta_rho = torch.where(
        small,
        eta_s * rho,
        -2.0 * c * smrho_l + rel_jitter * diag0 * rho,
    )

    gamma_s = c * es * es * torch.exp(-us)  # γ = c(1−ρ)²/ρ
    a_minus_2b = torch.where(
        small,
        gamma_s + eta_s * (1.0 + rho) / omr,
        diag0 * (1.0 + rel_jitter) * (1.0 + rho) / omr - 2.0 * c * omr,
    )
    a_plus_2b = (diag0 * (1.0 + rel_jitter) * omr + 2.0 * c * omr * omr) / (1.0 + rho)
    a = 0.5 * (a_minus_2b + a_plus_2b)     # interior diagonal of C
    b = -eta_rho / s2                      # interior off-diagonal
    b0 = -eta_rho / s                      # C[0,1] (the KMS corner)
    a0 = diag0 * (1.0 + rel_jitter)        # C[0,0]
    sq = torch.sqrt(a_minus_2b * a_plus_2b)  # √(a² − 4b²)
    lam1 = 0.5 * (a + sq)
    return dict(u=u, rho=rho, s=s, a=a, b=b, b0=b0, a0=a0, sq=sq, lam1=lam1)


def m12_cell_inv_chol(m: int, delta, variance, lengthscale, rel_jitter):
    """Explicit F⁻¹ with F = chol(Kuu + jitter·I), closed form, O(m²).

    ``jitter = rel_jitter · Kuu[0, 0]``. Returns the (m, m) lower-triangular
    inverse Cholesky factor in the dtype and on the device of ``lengthscale``.
    """
    finv, f_mat = m12_cell_factors(m, delta, variance, lengthscale, rel_jitter)
    return newton_schulz_step(finv, f_mat)


def newton_schulz_step(finv, f_mat):
    """One Newton–Schulz step X ← X + X(I − F X), full fp32, lower part.

    The residual is squared: the step removes unstructured per-entry error
    of X (the JAX package measured ~1e-6 from TPU transcendentals) that the
    quadratic forms downstream would amplify by ~√cond(Kuu).
    """
    eye = torch.eye(finv.shape[0], dtype=finv.dtype, device=finv.device)
    with matmul_precision("highest"):
        resid = eye - f_mat @ finv
        finv = finv + finv @ resid
    return torch.tril(finv)


def m12_cell_factors(m: int, delta, variance, lengthscale, rel_jitter):
    """(raw closed-form F⁻¹, analytic F = L·G), both (m, m) lower-triangular;
    :func:`m12_cell_inv_chol` refines the first against the second."""
    dtype, device = lengthscale.dtype, lengthscale.device
    co = _tridiag_coefficients(delta, variance, lengthscale, rel_jitter)
    u, rho, s = co["u"], co["rho"], co["s"]
    a, b, b0, a0, sq, lam1 = (co["a"], co["b"], co["b0"], co["a0"],
                              co["sq"], co["lam1"])

    # Leading principal minors D_k of C in closed form, normalised by λ₁ᵏ.
    lam2 = (b * b) / lam1
    d1 = a0
    d2 = a * d1 - b0 * b0
    coefA = (d2 - lam2 * d1) / sq
    coefB = (lam1 * d1 - d2) / sq
    r = lam2 / lam1
    ones = torch.ones((m,), dtype=dtype, device=device)
    r_pow = torch.cumprod(torch.cat([ones[:1], ones[1:] * r]), 0)   # r^k
    fvec = coefA + coefB * r_pow           # D_{k+1} / λ₁ᵏ

    # (G⁻¹)_ij = sgn · q^{i−j} · D̂[j] / √(λ₁ D̂[i] D̂[i+1]), geometric factor
    # by cumprod (exact multiplies), the j = 0 column using b0/λ₁.
    q = torch.abs(b) / lam1
    qb0 = torch.abs(b0) / lam1
    q_pow = torch.cumprod(torch.cat([ones[:1], ones[1:] * q]), 0)   # q^k
    dhat = torch.cat([ones[:1], fvec / lam1])                       # D̂_0..D̂_m

    idx = torch.arange(m, device=device)
    i0 = idx[:, None]
    j0 = idx[None, :]
    inv_den = 1.0 / torch.sqrt(lam1 * dhat[i0] * dhat[i0 + 1])      # (m, 1)
    band = sym_toeplitz_dense(q_pow)                                # q^|i−j|
    col0 = qb0 * torch.cat([ones[:1], q_pow[:-1]])
    mag = torch.where(j0 == 0, torch.where(i0 > 0, col0[:, None], 1.0), band)
    neg_sign_b = torch.where(b >= 0, -1.0, 1.0).to(dtype)
    sgn = torch.where((i0 - j0) % 2 == 1, neg_sign_b, 1.0)
    ginv = torch.where(i0 >= j0, sgn * mag * dhat[j0] * inv_den, 0.0)

    # F⁻¹ = G⁻¹ L⁻¹ with L⁻¹ bidiagonal: diag (1, 1/s, …), subdiag −ρ/s.
    ld = torch.cat([ones[:1], ones[1:] / s])
    finv = ginv * ld[None, :] + F.pad(ginv[:, 1:] * (-rho / s), (0, 1))

    # The analytic factor F = L·G. ρᵏ via exp(−k·u), not a cumprod of ρ.
    rho_pow = torch.exp(-torch.arange(m, dtype=dtype, device=device) * u)
    col_s = torch.cat([ones[:1], ones[1:] * s])
    lt = torch.where(i0 >= j0, sym_toeplitz_dense(rho_pow) * col_s[None, :], 0.0)
    dvec = torch.sqrt(lam1 * dhat[1:] / dhat[:-1])          # G diagonal d_1..d_m
    f_mat = lt * dvec[None, :]
    if m >= 2:
        esub = torch.where(idx[:-1] == 0, b0, b) / dvec[:-1]   # G subdiagonal
        f_mat = f_mat + F.pad(lt[:, 1:] * esub[None, :], (0, 1))
    return finv, f_mat


def m12_geometric_ratio(delta, lengthscale, rel_jitter):
    """The geometric decay ratio q = |b|/λ₁ of the F⁻¹ entries (variance
    cancels). Gates the banded apply."""
    co = _tridiag_coefficients(delta, torch.ones_like(lengthscale), lengthscale,
                               rel_jitter)
    return torch.abs(co["b"]) / co["lam1"]


BAND_BLOCK = 128


def below_band_gate(q) -> bool:
    """Whether the geometric ratio ``q`` is below the 0.7 gate of the
    banded applies: a Python branch that reads ``q`` back to the host, so
    the host waits for the device (inside ``vggp.sync.band_gate``)."""
    with span("vggp.sync.band_gate"):
        return bool(q < 0.7)


def band_blocks(finv: torch.Tensor):
    """(diag, sub) blocks of a block-bidiagonal F⁻¹ at :data:`BAND_BLOCK`:
    ``diag[r] = F⁻¹[r, r]`` (nb, BB, BB) and ``sub[r] = F⁻¹[r+1, r]``
    (nb−1, BB, BB)."""
    m = finv.shape[0]
    nb = m // BAND_BLOCK
    f4 = finv.reshape(nb, BAND_BLOCK, nb, BAND_BLOCK)
    diag = f4.diagonal(0, 0, 2).permute(2, 0, 1)
    sub = f4[1:, :, :-1, :].diagonal(0, 0, 2).permute(2, 0, 1)
    return diag, sub


def banded_apply(finv: torch.Tensor, kuf: torch.Tensor) -> torch.Tensor:
    """F⁻¹·Kuf over the block-bidiagonal band only (m % BAND_BLOCK == 0,
    m ≥ 2·BAND_BLOCK): one batched product per band."""
    m = finv.shape[0]
    nb = m // BAND_BLOCK
    diag, sub = band_blocks(finv)
    kb = kuf.reshape(nb, BAND_BLOCK, -1)
    out = torch.bmm(diag, kb)
    lower = torch.bmm(sub, kb[:-1])
    return torch.cat([out[:1], out[1:] + lower]).reshape(m, -1)


def banded_whiten_apply(finv, kuf, q, precision):
    """a = F⁻¹·Kuf exploiting the geometric decay of the structured factor.

    The block-bidiagonal product discards entries ≤ q^(BAND_BLOCK+1), at
    most 9e-16 below the q < 0.7 gate; at or above the gate, and for shapes
    that do not block evenly, the dense product is taken. The gate is
    :func:`below_band_gate`.
    """
    m = finv.shape[0]
    with matmul_precision(precision):
        if m % BAND_BLOCK != 0 or m // BAND_BLOCK < 2 or not below_band_gate(q):
            return finv @ kuf
        return banded_apply(finv, kuf)


# --------------------------------------------------------------------------- #
# KMS tridiagonal-inverse pieces of the matrix-free CG path (``kms.py:271-313``)
# --------------------------------------------------------------------------- #


def kms_gamma_rho(delta, variance, lengthscale, u_cap: float = 30.0,
                  u_floor: float = 0.0):
    """(γ, ρ, 1 − ρ²) of the exact decomposition Kuu = γ·KMS(ρ) + η·I.

    The stable forms of :func:`_tridiag_coefficients` (ρ by the expm1 series
    near 1, γ = c(1 − ρ)²/ρ through ``expm1s``). ``u = δ/ℓ`` is capped (γ
    grows like c·eᵘ and overflows float32 past u ≈ 88; by the cap the Gram
    is diagonal to working precision) and floored: the tridiagonal KMS⁻¹
    applied to a smooth vector cancels to about u²·|v|, so below u ≈ √eps
    the apply is rounding noise amplified by 1/γ. The only consumer is a
    preconditioner, for which a floored u builds the exact factors of a
    coarser grid's Gram: still SPD, a weaker preconditioner, never garbage.
    Pass ``u_floor = 5·√eps`` of the dtype.
    """
    u = torch.clamp(delta / lengthscale, u_floor, u_cap)
    rho = torch.where(u < 1.0, 1.0 + expm1s(-torch.clamp(u, max=1.0)),
                      torch.exp(-torch.clamp(u, min=1.0)))
    omr = -expm1s(-u)                       # 1 − ρ
    s2 = -expm1s(-2.0 * u)                  # 1 − ρ²
    c = variance * lengthscale * lengthscale
    gamma = c * omr * omr / rho
    return gamma, rho, s2


def kms_tinv_matvec(rho, s2, v: torch.Tensor) -> torch.Tensor:
    """KMS(ρ)⁻¹ @ v by the closed tridiagonal inverse, O(m), no solve:
    T⁻¹ = tridiag(−ρ | 1 + ρ², with the corner diagonals 1)/(1 − ρ²).
    ``v`` is (m,) or (m, k), applied along axis 0."""
    squeeze = v.dim() == 1
    if squeeze:
        v = v[:, None]
    r2 = rho * rho
    ends = torch.zeros((v.shape[0], 1), dtype=v.dtype, device=v.device)
    ends[0] += 1.0
    ends[-1] += 1.0                         # both corners on one row when m = 1
    w = (1.0 + r2) * v - r2 * ends * v
    w = w - rho * F.pad(v[:-1], (0, 0, 1, 0)) - rho * F.pad(v[1:], (0, 0, 0, 1))
    out = w / s2
    return out[:, 0] if squeeze else out
