"""Closed-form inverse Cholesky of the Matérn-1/2 cell-integral Kuu (port of
``vggp_tpu/ops/kms.py:47-263``).

The uniform-mesh B0 cell Gram decomposes exactly as γ·KMS(ρ) + η·I, so the
inverse Cholesky factor of the jittered Gram is built in O(m²) elementwise
work from the minors of a tridiagonal matrix, then refined by one
Newton–Schulz step against the analytic factor. The module docstring of the
JAX package derives every step; the code below keeps its order of operations
so that the two agree to roundoff in float64.

On a CUDA tensor the raw factor, the analytic factor and the band ratio come
from one launch of ``csrc/m12_finv.cu`` (:func:`m12_finv`); its plain
version, :func:`m12_cell_factors_plain` with :func:`m12_geometric_ratio`, is
what the CPU runs.
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


def m12_cell_inv_chol_and_ratio(m: int, delta, variance, lengthscale, rel_jitter):
    """(:func:`m12_cell_inv_chol`, :func:`m12_geometric_ratio`) from one
    :func:`m12_finv`: on the card one launch and the Newton–Schulz step."""
    finv, f_mat, q = m12_finv(m, delta, variance, lengthscale, rel_jitter)
    return newton_schulz_step(finv, f_mat), q


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
    :func:`m12_cell_inv_chol` refines the first against the second. The
    plain version on the CPU, the ``m12_finv`` kernel on the card."""
    if _checked_on_cpu(m, variance, lengthscale):
        return m12_cell_factors_plain(m, delta, variance, lengthscale, rel_jitter)
    return m12_finv(m, delta, variance, lengthscale, rel_jitter)[:2]


def m12_cell_factors_plain(m: int, delta, variance, lengthscale, rel_jitter):
    """:func:`m12_cell_factors` on tensors — the plain version of the
    ``m12_finv`` kernel's two (m, m) outputs."""
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
    cancels). Gates the banded apply. Plain torch on every device: the
    ``m12_finv`` kernel returns the same number beside the factors."""
    co = _tridiag_coefficients(delta, torch.ones_like(lengthscale), lengthscale,
                               rel_jitter)
    return torch.abs(co["b"]) / co["lam1"]


# --------------------------------------------------------------------------- #
# the m12_finv kernel (csrc/m12_finv.cu): wrapper and autograd
# --------------------------------------------------------------------------- #

def _checked_on_cpu(m: int, variance, lengthscale) -> bool:
    """Validate :func:`m12_finv`'s inputs; True when they lie on the CPU."""
    from vggp_tpu_torch.ops.cell_kuf import _SUFFIX

    if not isinstance(lengthscale, torch.Tensor) or lengthscale.dtype not in _SUFFIX:
        raise TypeError("m12_finv takes a float32 or float64 lengthscale tensor, got "
                        f"{getattr(lengthscale, 'dtype', type(lengthscale))}")
    if not isinstance(variance, torch.Tensor) or variance.dtype != lengthscale.dtype:
        raise TypeError(f"variance must be a {lengthscale.dtype} tensor, got "
                        f"{getattr(variance, 'dtype', type(variance))}")
    for name, t in (("variance", variance), ("lengthscale", lengthscale)):
        if t.dim() != 0:
            raise ValueError(f"{name} must be 0-d, got shape {tuple(t.shape)}")
    if int(m) != m or m < 1:
        raise ValueError(f"m12_finv needs m ≥ 1 cells, got {m}")
    if variance.device != lengthscale.device:
        raise ValueError(f"variance on {variance.device}, lengthscale on {lengthscale.device}")
    if lengthscale.device.type not in ("cpu", "cuda"):
        raise ValueError(f"m12_finv runs on CUDA (or plainly on the CPU), not "
                         f"{lengthscale.device}")
    return lengthscale.device.type == "cpu"


def m12_finv_plain(m: int, delta, variance, lengthscale, rel_jitter):
    """(raw F⁻¹, F, q) on tensors — the plain version of :func:`m12_finv`."""
    return (*m12_cell_factors_plain(m, delta, variance, lengthscale, rel_jitter),
            m12_geometric_ratio(delta, lengthscale, rel_jitter))


def _m12_finv_values(m: int, delta, variance, lengthscale, rel_jitter):
    """(raw F⁻¹, F, q) as values: one kernel launch on the card, the plain
    version under ``no_grad`` on the CPU."""
    if lengthscale.device.type == "cpu":
        with torch.no_grad():
            return m12_finv_plain(m, delta, variance, lengthscale, rel_jitter)
    from vggp_tpu_torch.ops import _build
    from vggp_tpu_torch.ops import cell_kuf as ck

    lib = _build.load()
    like = lengthscale
    scal = ck._scal(variance, lengthscale, like)
    finv = torch.empty((m, m), dtype=like.dtype, device=like.device)
    f_mat = torch.empty_like(finv)
    q = torch.empty((), dtype=like.dtype, device=like.device)
    rc = getattr(lib, f"m12_finv_{ck._SUFFIX[like.dtype]}")(
        ck._ptr(scal), float(delta), float(rel_jitter), ck._ptr(finv), ck._ptr(f_mat),
        ck._ptr(q), m, ck._stream(like))
    ck._raise_on(rc, "m12_finv")
    ck._count("m12_finv", m, m)
    return finv, f_mat, q


class M12FinvOp(torch.autograd.Function):
    """(raw F⁻¹, F, q) with the values of :func:`_m12_finv_values` (the
    kernel on the card) and the backward of the plain version: it rebuilds
    :func:`m12_finv_plain` under autograd and differentiates it, with a graph
    when one is asked for (``create_graph``, the first pass of a Hessian), so
    every order of derivative is the plain version's."""

    @staticmethod
    def forward(ctx, variance, lengthscale, m, delta, rel_jitter):
        ctx.save_for_backward(variance, lengthscale)
        ctx.args = (m, delta, rel_jitter)
        return _m12_finv_values(m, delta, variance, lengthscale, rel_jitter)

    @staticmethod
    def backward(ctx, g_finv, g_f, g_q):
        m, delta, rel_jitter = ctx.args
        graph = torch.is_grad_enabled()
        needs = ctx.needs_input_grad[:2]
        inputs = [t if graph else t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, needs)]
        wrt = [t for t, need in zip(inputs, needs) if need]
        with torch.enable_grad():
            outs = [(o, g) for o, g in zip(m12_finv_plain(m, delta, *inputs, rel_jitter),
                                           (g_finv, g_f, g_q)) if o.requires_grad]
            grads = iter(torch.autograd.grad([o for o, _ in outs], wrt, [g for _, g in outs],
                                             create_graph=graph))
        return (*(next(grads) if need else None for need in needs), None, None, None)


def m12_finv(m: int, delta, variance, lengthscale, rel_jitter):
    """(raw closed-form F⁻¹, analytic F = L·G, band ratio q) of the
    Matérn-1/2 cell Gram on a uniform mesh of m cells of width ``delta``.

    On the CPU the plain version (:func:`m12_finv_plain`, autograd as any
    torch code). On the card one launch of the ``m12_finv`` kernel, counted
    in ``ops.cell_kuf.LAUNCHES``; where σ² or ℓ needs a gradient, through
    :class:`M12FinvOp`. ``variance`` and ``lengthscale`` are 0-d tensors of
    one floating dtype on one device; ``q`` is :func:`m12_geometric_ratio`'s
    number (variance 1).
    """
    if _checked_on_cpu(m, variance, lengthscale):
        return m12_finv_plain(m, delta, variance, lengthscale, rel_jitter)
    if torch.is_grad_enabled() and (variance.requires_grad or lengthscale.requires_grad):
        return M12FinvOp.apply(variance, lengthscale, m, delta, rel_jitter)
    return _m12_finv_values(m, delta, variance, lengthscale, rel_jitter)


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
