"""Inducing features of the port (``vggp_tpu/features.py``), one family per
input axis, each with its covariance blocks Kuu (m, m), Kuf (m, n) against
f(x) and Kvu (g, m) against the B0 cell integrals of a serving grid:

- :class:`AxisFeature`, the base class: dense fallbacks, the forward-mode
  ℓ- and x-tangents of Kuf, and ``None`` from the cell-only hooks of the
  scalar-tangent whitening (``models.common``);
- :class:`PointFeature`, free inducing points (the SVGP), z learnable;
- :class:`FourierFeature`, variational Fourier features (VFF) on [a, b]
  with a diagonal-plus-low-rank Kuu and the Markov continuation outside;
- :class:`B1SplineFeature` and :class:`SplineRKHSFeature` (B2, B3), the
  B-spline RKHS features of ASVGP;
- :class:`CellIntegralFeature`, the B0 cell integrals of the GriddedGP, for
  the Matérn-1/2, 3/2, 5/2 and RBF kernels on uniform and non-uniform
  meshes, with the cell/point derivative blocks of the gradient heads;
- :class:`OutputFeature`, the discrete output axis of the multi-output (ICM)
  models, paired with the ``"coregion"`` kind.

The Matérn-1/2 cell Kuf takes the ``cell_kuf`` kernels on any mesh;
everything else is plain torch, as the JAX package computes it in jnp.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict

import numpy as np
import torch

from vggp_tpu_torch import config, kernels
from vggp_tpu_torch.ops import cell_kuf as ck
from vggp_tpu_torch.ops import diag_lowrank, toeplitz
from vggp_tpu_torch.ops.stablemath import expm1mx, expm1s, gamma2_lower, gamma3_lower
from vggp_tpu_torch.tracing import span, traced

Params = Dict


# --------------------------------------------------------------------------- #
# Matérn closed forms (``vggp_tpu/features.py:53-366``)
#
# For k(r) = σ² p(λr) e^{−λr}, the once- and twice-integrated kernels are
#   G(R) = σ²[(g0/λ)(1 − e^{−λR}) − e^{−λR}(g1 R + g2 λR²)]
#   P(r) = σ²[c_lin r/λ + (c0/λ²) expm1(−λr) + e^{−λr}(c1 r/λ + c2 r²)]
# with λ = 1/ℓ, √3/ℓ, √5/ℓ. Every difference of nearby exponentials goes
# through the ops.stablemath series.
# --------------------------------------------------------------------------- #

#                 c_lin   c0    c1     c2     g0     g1     g2
_CELL_COEFFS = {
    "matern12": (1.0,    1.0,  0.0,   0.0,   1.0,   0.0,   0.0),
    "matern32": (2.0,    3.0,  1.0,   0.0,   2.0,   1.0,   0.0),
    "matern52": (8/3,    5.0,  7/3,   1/3,   8/3,   5/3,   1/3),
}


def _lam_of(kind: str, lengthscale):
    return kernels.lam(kind, lengthscale)


# RBF: G(R) = σ²ℓ√(π/2)·erf(R/(ℓ√2)),
#      P(r) = σ²[ℓ√(π/2)·r·erf(r/(ℓ√2)) + ℓ²(e^{−r²/(2ℓ²)} − 1)];
# differences of nearby values through erfc (tail-accurate) and expm1.
_SQRT_HALF_PI = math.sqrt(math.pi / 2.0)
_INV_SQRT2 = 1.0 / math.sqrt(2.0)


def _rbf_cell_point_cov(mesh, x, variance, lengthscale):
    x = x.reshape(-1)
    a = mesh[:-1, None]
    b = mesh[1:, None]
    u = torch.abs(x[None, :] - a)
    w = torch.abs(x[None, :] - b)
    inside = (x[None, :] >= a) & (x[None, :] <= b)
    c = lengthscale * _SQRT_HALF_PI

    def G(R):
        return c * torch.special.erf(R * _INV_SQRT2 / lengthscale)

    inside_val = G(u) + G(w)
    near = torch.minimum(u, w)
    far = torch.maximum(u, w)
    # G(far) − G(near) = c·(erfc(near′) − erfc(far′)), tail-accurate
    outside_val = c * (torch.special.erfc(near * _INV_SQRT2 / lengthscale)
                       - torch.special.erfc(far * _INV_SQRT2 / lengthscale))
    return variance * torch.where(inside, inside_val, outside_val)


def _rbf_cell_cell_cov(mesh_a, mesh_b, variance, lengthscale):
    a1, b1 = mesh_a[:-1, None], mesh_a[1:, None]
    a2, b2 = mesh_b[None, :-1], mesh_b[None, 1:]
    ell2 = lengthscale * lengthscale
    A = lengthscale * _SQRT_HALF_PI

    def pdiff(u_pos, u_neg):
        """P(|u_pos|) − P(|u_neg|), compensated."""
        ap, an = torch.abs(u_pos), torch.abs(u_neg)
        mx, mn = torch.maximum(ap, an), torch.minimum(ap, an)
        s = torch.where(ap >= an, 1.0, -1.0)
        d = mx - mn
        zmx = mx * _INV_SQRT2 / lengthscale
        zmn = mn * _INV_SQRT2 / lengthscale
        # M·erf(M′) − m·erf(m′) = d·erf(M′) + m·(erfc(m′) − erfc(M′))
        t1 = d * torch.special.erf(zmx) + mn * (torch.special.erfc(zmn)
                                                - torch.special.erfc(zmx))
        # e^{−M²/2ℓ²} − e^{−m²/2ℓ²} = e^{−m²/2ℓ²}·expm1(−d(M + m)/(2ℓ²))
        t2 = torch.exp(-0.5 * mn * mn / ell2) * expm1s(-0.5 * d * (mx + mn) / ell2)
        return s * (A * t1 + ell2 * t2)

    return variance * (pdiff(b1 - a2, a1 - a2) + pdiff(a1 - b2, b1 - b2))


def _cell_point_cov(kind: str, mesh, x, variance, lengthscale):
    """Cov[v_i, f(x_j)] = ∫_cell_i k(|x_j − t|) dt, (m, n): the Matérn
    orders by their poly-exponential antiderivatives, the RBF by erf."""
    if kind == "rbf":
        return _rbf_cell_point_cov(mesh, x, variance, lengthscale)
    c_lin, c0, c1, c2, g0, g1, g2 = _CELL_COEFFS[kind]
    lam = _lam_of(kind, lengthscale)
    x = x.reshape(-1)
    a = mesh[:-1, None]
    b = mesh[1:, None]
    u = torch.abs(x[None, :] - a)
    w = torch.abs(x[None, :] - b)
    inside = (x[None, :] >= a) & (x[None, :] <= b)

    def G(R):
        z = lam * R
        return (g0 / lam) * (-expm1s(-z)) - torch.exp(-z) * (g1 * R + g2 * lam * R * R)

    inside_val = G(u) + G(w)
    # outside: G(far) − G(near), far − near = the cell width, compensated
    near = torch.minimum(u, w)
    far = torch.maximum(u, w)
    d = b - a
    zd = lam * d
    outside_val = torch.exp(-lam * near) * (
        -(g0 / lam + g1 * near + g2 * lam * near * near) * expm1s(-zd)
        - torch.exp(-zd) * d * (g1 + g2 * lam * (far + near)))
    return variance * torch.where(inside, inside_val, outside_val)


def _cell_cell_cov(kind: str, mesh_a, mesh_b, variance, lengthscale):
    """Cov[∫_{A_i} f, ∫_{B_j} f] for any kind, compensated. (ga, gb).

    ``∬ k = Σ± P(|u|)`` over the four corner differences; the linear part of
    P telescopes exactly to ``(c_lin/λ)·2·overlap`` and the decaying part is
    grouped into two compensated nearby-exponential differences.
    """
    if kind == "rbf":
        return _rbf_cell_cell_cov(mesh_a, mesh_b, variance, lengthscale)
    c_lin, c0, c1, c2 = _CELL_COEFFS[kind][:4]
    lam = _lam_of(kind, lengthscale)
    a1, b1 = mesh_a[:-1, None], mesh_a[1:, None]
    a2, b2 = mesh_b[None, :-1], mesh_b[None, 1:]

    def fdiff(u_pos, u_neg):
        """f(|u_pos|) − f(|u_neg|) for P's decaying part f, compensated."""
        ap, an = torch.abs(u_pos), torch.abs(u_neg)
        mx, mn = torch.maximum(ap, an), torch.minimum(ap, an)
        s = torch.where(ap >= an, 1.0, -1.0)
        d = mx - mn
        zd = lam * d
        val = torch.exp(-lam * mn) * (
            (c0 / (lam * lam) + c1 * mn / lam + c2 * mn * mn) * expm1s(-zd)
            + torch.exp(-zd) * d * (c1 / lam + c2 * (mx + mn)))
        return s * val

    epart = fdiff(b1 - a2, a1 - a2) + fdiff(a1 - b2, b1 - b2)
    overlap = torch.clamp(torch.minimum(b1, b2) - torch.maximum(a1, a2), min=0.0)
    return variance * (epart + (c_lin / lam) * 2.0 * overlap)


def _m12_cell_point_cov(mesh, x, variance, lengthscale):
    """Cov[v_i, f(x_j)] for v_i = ∫_{cell i} f, Matérn-1/2 kernel. (m, n).

    The branch-free 3-case closed form with the per-element series: inside
    [a_i, b_i] σ²ℓ(2 − e^{−u} − e^{−w}), outside σ²ℓ·e^{−min(u,w)}(1 − e^{−δ/ℓ}).
    A reference form: :meth:`CellIntegralFeature.Kuf` takes ``cell_kuf``.
    """
    x = x.reshape(-1)
    a = mesh[:-1, None]
    b = mesh[1:, None]
    u = torch.abs(x[None, :] - a) / lengthscale
    w = torch.abs(x[None, :] - b) / lengthscale
    inside = (x[None, :] >= a) & (x[None, :] <= b)
    near = torch.minimum(u, w)
    dd = (b - a) / lengthscale
    outside_val = torch.exp(-near) * (-expm1s(-dd))
    inside_val = -(expm1s(-u) + expm1s(-w))
    return variance * lengthscale * torch.where(inside, inside_val, outside_val)


def _m12_cell_gram(mesh, variance, lengthscale):
    """Kuu of Matérn-1/2 cells on any mesh, without cancellation: over two
    disjoint cells ∬ e^{−|s−t|/ℓ} = ℓ²(1 − e^{−δ_i/ℓ})(1 − e^{−δ_j/ℓ})e^{−g_ij/ℓ}
    (g_ij the gap between them), over one cell 2ℓ²(e^{−δ_i/ℓ} − 1 + δ_i/ℓ);
    the uniform-mesh Toeplitz row is its special case. The widths δ_i are
    differences of neighbouring edges, exact in the mesh's own dtype, as
    the ``cell_kuf`` kernels take them.

    The JAX package builds this Gram by the generic :func:`_cell_cell_cov`,
    whose four-corner sum cancels with (ℓ/δ)² amplification: on a 512-cell
    mesh refined toward its middle, at ℓ/δ ≈ 700, its float32 Gram has
    λ_min ≈ −0.56 of its diagonal and no Cholesky, on the CPU in both
    packages (ROADMAP queue 3). This form agrees with it to roundoff in
    float64.
    """
    a, b = mesh[:-1], mesh[1:]
    gap = torch.clamp(torch.maximum(a[None, :] - b[:, None], a[:, None] - b[None, :]), min=0.0)
    d = (b - a) / lengthscale
    omr = -expm1s(-d)                       # 1 − e^{−δ_i/ℓ}
    off = omr[:, None] * omr[None, :] * torch.exp(-gap / lengthscale)
    gram = off + torch.diag(2.0 * expm1mx(-d) - torch.diagonal(off))
    return variance * lengthscale ** 2 * gram


def _m12_toeplitz_first_row(m: int, delta, variance, lengthscale, dtype):
    """First row of the uniform-mesh B0 cell-integral Kuu (Toeplitz):
    row[k] = σ²ℓ²(1 − e^{−δ/ℓ})² e^{−(k−1)δ/ℓ} for k ≥ 1 and
    row[0] = 2σ²ℓ²(e^{−δ/ℓ} − 1 + δ/ℓ), both without cancellation."""
    k = torch.arange(m, dtype=dtype, device=lengthscale.device)
    d = delta / lengthscale
    omr = -expm1s(-d)                       # 1 − e^{−δ/ℓ}
    tail = omr * omr * torch.exp(-torch.clamp(k - 1.0, min=0.0) * d)
    head = 2.0 * expm1mx(-d)
    row = torch.where(k == 0, head, tail)
    return variance * lengthscale ** 2 * row


def _m12_toeplitz_first_row_dl(m: int, delta, variance, lengthscale, dtype):
    """∂/∂ℓ of :func:`_m12_toeplitz_first_row`, in closed form.

    With d = δ/ℓ (∂d/∂ℓ = −d/ℓ), ρ = e^{−d} and 1 − ρ by the series:
    row[0]′ = 2σ²ℓ(2(e^{−d} − 1 + d) − d(1 − ρ)) and, for k ≥ 1,
    row[k]′ = σ²ℓ(1 − ρ)e^{−(k−1)d}(2(1 − ρ) − 2dρ + (k − 1)d(1 − ρ)).
    The same terms as the forward-mode derivative of the row, without the
    per-call cost of a forward-mode trace.
    """
    k = torch.arange(m, dtype=dtype, device=lengthscale.device)
    d = delta / lengthscale
    omr = -expm1s(-d)                       # 1 − e^{−δ/ℓ}
    km1 = torch.clamp(k - 1.0, min=0.0)
    tail = omr * torch.exp(-km1 * d) * (2.0 * omr - 2.0 * d * torch.exp(-d) + km1 * d * omr)
    head = 2.0 * (2.0 * expm1mx(-d) - d * omr)
    return variance * lengthscale * torch.where(k == 0, head, tail)


def _cell_p_series(kind: str, t):
    """h(t) = P(r)·λ²/σ² = c_lin t + c0 expm1(−t) + e^{−t}(c1 t + c2 t²).

    The naive form cancels to O(t²), so for t < 1 it is the explicit Taylor
    series a_k = (−1)ᵏ(c0 − c1·k + c2·k(k−1))/k!, k ≥ 2. Both branches stay
    finite (``ts``, ``tl``), so no NaN reaches a tangent through the select.
    """
    c_lin, c0, c1, c2 = _CELL_COEFFS[kind][:4]
    coeffs = [(c0 - c1 * k + c2 * k * (k - 1)) * (1.0 if k % 2 == 0 else -1.0)
              / math.factorial(k) for k in range(2, 16)]
    small = torch.abs(t) < 1.0
    ts = torch.where(small, t, 0.0)
    acc = torch.zeros_like(t) + coeffs[-1]
    for c in reversed(coeffs[:-1]):
        acc = acc * ts + c
    series = acc * ts * ts
    tl = torch.where(small, 1.0, t)
    direct = c_lin * tl + c0 * expm1s(-tl) + torch.exp(-tl) * (c1 * tl + c2 * tl * tl)
    return torch.where(small, series, direct)


def _cell_toeplitz_first_row(kind: str, m: int, delta, variance, lengthscale, dtype):
    """Uniform-mesh cell Kuu first row of the Matérn-3/2 and 5/2 orders,
    with the second central difference of P taken analytically (the generic
    cell/cell form cancels with (ℓ/δ)² amplification). With s = λδ and
    t = λkδ, each tail term is normalised by e^{−(k−1)s} so every exponential
    factor is bounded:
      4sinh²(s/2)·e^{−t} = (1 − e^{−s})²·e^{−(k−1)s}
      2s·sinh(s)·e^{−t}  = s(1 − e^{−2s})·e^{−(k−1)s}
      2s²·cosh(s)·e^{−t} = s²(1 + e^{−2s})·e^{−(k−1)s}.
    The diagonal is 2P(δ) by :func:`_cell_p_series`.
    """
    _, c0, c1, c2 = _CELL_COEFFS[kind][:4]
    lam = _lam_of(kind, lengthscale)
    s = lam * delta
    k = torch.arange(m, dtype=dtype, device=lengthscale.device)
    t = k * s
    omr = -expm1s(-s)                  # 1 − e^{−s}
    omr2 = -expm1s(-2.0 * s)           # 1 − e^{−2s}
    opr2 = 2.0 + expm1s(-2.0 * s)      # 1 + e^{−2s}
    decay = torch.exp(-torch.clamp(k - 1.0, min=0.0) * s)
    tail = decay * (omr * omr * (c0 + c1 * t + c2 * t * t)
                    - s * omr2 * (c1 + 2.0 * c2 * t)
                    + c2 * s * s * opr2)
    head = 2.0 * _cell_p_series(kind, s)
    row = torch.where(k == 0, head, tail)
    return variance / (lam * lam) * row


# 24-point Gauss–Legendre rule on [0, 1] (positive weights: no cancellation);
# device copies by (dtype, device), made once, as ``mesh_j`` keeps the mesh.
_GL24_NODES, _GL24_WEIGHTS = np.polynomial.legendre.leggauss(24)
_GL24_S = 0.5 * (_GL24_NODES + 1.0)
_GL24_W = 0.5 * _GL24_WEIGHTS
_GL24_ON_DEVICE: dict = {}


def _gl24(dtype, device):
    key = (dtype, device)
    if key not in _GL24_ON_DEVICE:
        _GL24_ON_DEVICE[key] = (torch.as_tensor(_GL24_S, dtype=dtype, device=device),
                                torch.as_tensor(_GL24_W, dtype=dtype, device=device))
    return _GL24_ON_DEVICE[key]


def _rbf_toeplitz_first_row(m: int, delta, variance, lengthscale, dtype):
    """Uniform-mesh RBF cell Kuu first row, in two regimes:

    - δ ≤ 2ℓ: row[k] = ∫₀^δ (δ − s)·[k(kδ + s) + k(kδ − s)] ds (the tent
      autocorrelation form) by the 24-point Gauss–Legendre rule: positive
      weights and integrand, no cancellation;
    - δ > 2ℓ: Δ²P in closed form with the erf differences through erfc
      (erf(x_{k+1}) − erf(x_k) = erfc(x_k) − erfc(x_{k+1})).

    Both branches are bounded everywhere (``torch.where`` evaluates both).
    """
    k = torch.arange(m, dtype=dtype, device=lengthscale.device)
    ell = lengthscale
    gl_s, gl_w = _gl24(dtype, lengthscale.device)
    s = gl_s * delta
    w = gl_w * delta
    ctr = k[:, None] * delta
    inv2 = 0.5 / (ell * ell)
    gsum = torch.exp(-(ctr + s[None, :]) ** 2 * inv2) + torch.exp(-(ctr - s[None, :]) ** 2 * inv2)
    row_gl = torch.sum(w[None, :] * (delta - s[None, :]) * gsum, dim=1)
    h = delta * _INV_SQRT2 / ell
    x = torch.arange(m + 1, dtype=dtype, device=lengthscale.device) * h
    d_up = torch.special.erfc(x[:-1]) - torch.special.erfc(x[1:])  # erf(x_{j+1}) − erf(x_j)
    dm = torch.cat([d_up[:1], d_up[:-1]])       # Δ⁻; k = 0 takes Δ⁺ (erf is odd)
    g = torch.exp(-x * x)
    g_km1 = torch.cat([g[1:2], g[:m - 1]])      # g[|k − 1|]
    e2 = g[1:] - 2.0 * g[:-1] + g_km1
    t_part = _SQRT_HALF_PI * ell * delta * ((k + 1.0) * d_up - (k - 1.0) * dm)
    row_cf = t_part + ell * ell * e2
    return variance * torch.where(delta <= 2.0 * ell, row_gl, row_cf)


def ell_tangent(fn, ell):
    """(fn(ℓ), ∂fn(ℓ)/∂ℓ) by forward-mode AD: one pass with a dual ℓ of unit
    tangent (``torch.autograd.forward_ad``). The tensors fn creates stay
    plain, unlike under ``torch.func.jvp``, which wraps them, so the device
    caches it fills (``mesh_j``, the GL-24 constants) stay usable after it.
    A function that does not read ℓ (a spline basis) has a zero tangent."""
    import torch.autograd.forward_ad as fwAD

    with fwAD.dual_level():
        if not torch._C._is_fwd_grad_enabled():
            raise RuntimeError("forward-mode AD is off here (as inside an "
                               "autograd.Function's forward)")
        primal, tangent = fwAD.unpack_dual(fn(fwAD.make_dual(ell, torch.ones_like(ell))))
    return primal, torch.zeros_like(primal) if tangent is None else tangent


def _cached(cache: dict, key, make):
    """``cache[key]``, made by ``make()`` on first use. A tensor made under a
    ``torch.func`` transform is a wrapper that does not outlive it, so it is
    returned but not kept."""
    t = cache.get(key)
    if t is None:
        t = make()
        if not torch._C._functorch.is_functorch_wrapped_tensor(t):
            cache[key] = t
    return t


def _x_tangent(fn, x):
    """∂fn(x)/∂x column-wise, by forward mode with a unit tangent on every
    input (exact where column n depends on x_n alone). ``torch.func.jvp``,
    so that it nests (:meth:`AxisFeature.dKuf_dx2`)."""
    return torch.func.jvp(fn, (x,), (torch.ones_like(x),))[1]


class AxisFeature:
    """Base class of the per-axis features (``features.py:432-512``):
    concrete features implement ``Kuu``, ``Kuf`` and ``Kvu``. The hooks of
    the scalar-tangent whitening that only the Matérn-1/2 cells have return
    None here, so every other fixed basis takes the dense factor and the
    forward-mode tangents there."""

    m: int

    def init_params(self, dtype=None, device=None) -> Dict:
        """Feature-owned learnable parameters: none for a fixed basis."""
        return {}

    def _constant(self, name: str, array, like: torch.Tensor) -> torch.Tensor:
        """The static numpy ``array`` as a tensor of ``like``'s dtype and
        device, copied to the device once."""
        return _cached(self._cache, (name, like.dtype, like.device),
                       lambda: torch.as_tensor(array, dtype=like.dtype, device=like.device))

    def kuu_matvec(self, kind: str, p: Params, v: torch.Tensor) -> torch.Tensor:
        """Kuu @ v, dense; structured features override."""
        return self.Kuu(kind, p) @ v

    def kuu_operator(self, kind: str, p: Params):
        """The map v ↦ :meth:`kuu_matvec` (v), with what does not depend on v
        computed once: the matrix-free solves apply it every iteration."""
        K = self.Kuu(kind, p)
        return lambda v: K @ v

    def kuu_diag(self, kind: str, p: Params) -> torch.Tensor:
        """diag(Kuu), dense; structured features override (a row sum is no
        proxy: the B1 Gram's negative off-diagonals cancel its rows)."""
        return torch.diagonal(self.Kuu(kind, p))

    def kuu_first_row_dl(self, kind: str, p: Params):
        """∂(Toeplitz first row of Kuu)/∂ℓ in closed form, or None: the
        caller takes a forward-mode tangent of Kuu."""
        return None

    def extra_f32_jitter(self, kind: str) -> float:
        """Per-(feature, kind) float32 jitter floor on top of
        ``common.KIND_JITTER_F32``: none by default."""
        return 0.0

    def inv_chol_kuu(self, kind: str, p: Params, rel_jitter: float):
        """Closed-form F⁻¹ of the jittered Kuu, or None (the dense factor)."""
        return None

    def whiten_band_ratio(self, kind: str, p: Params, rel_jitter: float):
        """Geometric decay ratio of a banded F⁻¹, or None."""
        return None

    def inv_chol_kuu_and_ratio(self, kind: str, p: Params, rel_jitter: float):
        """(:meth:`inv_chol_kuu`, :meth:`whiten_band_ratio`), or None where
        there is no closed-form F⁻¹."""
        finv = self.inv_chol_kuu(kind, p, rel_jitter)
        return None if finv is None else (finv, self.whiten_band_ratio(kind, p, rel_jitter))

    def whitened_kuf_fused(self, kind: str, p: Params, finv, ratio, x):
        """(F⁻¹Kuf, F⁻¹∂Kuf/∂ℓ) from one fused kernel, or None."""
        return None

    def Kuf_dl(self, kind: str, p: Params, x: torch.Tensor):
        """∂Kuf/∂ℓ in closed form, or None: :meth:`Kuf_with_dl` then takes
        the forward-mode tangent of :meth:`Kuf`."""
        return None

    def Kuf_with_dl(self, kind: str, p: Params, x: torch.Tensor):
        """(Kuf, ∂Kuf/∂ℓ) as values for the scalar-tangent whitening: Kuf
        with :meth:`Kuf_dl`, or both from one forward-mode pass in ℓ."""
        dkuf = self.Kuf_dl(kind, p, x)
        if dkuf is None:
            return ell_tangent(lambda t: self.Kuf(kind, {**p, "lengthscale": t}, x),
                               p["lengthscale"])
        return self.Kuf(kind, p, x), dkuf

    def dKuf_dx(self, kind: str, p: Params, x: torch.Tensor) -> torch.Tensor:
        """Cov(u_i, ∂f(x_n)), (m, n): one forward-mode pass through Kuf
        with a unit tangent on every input; closed forms override."""
        return _x_tangent(lambda t: self.Kuf(kind, p, t), x.reshape(-1))

    def dKuf_dx2(self, kind: str, p: Params, x: torch.Tensor) -> torch.Tensor:
        """Cov(u_i, ∂²f(x_n)): forward mode through :meth:`dKuf_dx`."""
        return _x_tangent(lambda t: self.dKuf_dx(kind, p, t), x.reshape(-1))

    def kvu_quadrature(self, kind: str, p: Params, grid: "CellIntegralFeature",
                       n_quad: int = 512) -> torch.Tensor:
        """Kvu by the trapezoidal rule over each grid cell (a test oracle
        for the closed forms)."""
        ls = p["lengthscale"]
        out = []
        for lo, hi in zip(grid.mesh[:-1], grid.mesh[1:]):
            ts = np.linspace(lo, hi, n_quad)
            vals = self.Kuf(kind, p, torch.as_tensor(ts, dtype=ls.dtype, device=ls.device))
            out.append(np.trapezoid(vals.detach().cpu().numpy(), ts, axis=1))
        return torch.as_tensor(np.stack(out, axis=0))


@dataclass(frozen=True)
class PointFeature(AxisFeature):
    """Free inducing points u_i = f(z_i) along one axis (the SVGP). ``z``
    is learnable and lives in the axis's parameter dict."""

    m: int
    z_init: np.ndarray = None  # (m,) initial locations

    def init_params(self, dtype=torch.float32, device=None) -> Dict:
        z = self.z_init if self.z_init is not None else np.linspace(0.0, 1.0, self.m)
        return {"z": torch.as_tensor(z, dtype=dtype, device=device)}

    def Kuu(self, kind: str, p: Params) -> torch.Tensor:
        return kernels.gram_1d(kind, p["z"], p["z"], p["variance"], p["lengthscale"])

    def Kuf(self, kind: str, p: Params, x: torch.Tensor) -> torch.Tensor:
        return kernels.gram_1d(kind, p["z"], x, p["variance"], p["lengthscale"])

    def Kvu(self, kind: str, p: Params, grid: "CellIntegralFeature") -> torch.Tensor:
        return _cell_point_cov(kind, grid.mesh_j(p), p["z"], p["variance"], p["lengthscale"])

    def dKuf_dx(self, kind: str, p: Params, x: torch.Tensor) -> torch.Tensor:
        """Cov(f(z_i), ∂f(x_n)) = k′(x_n − z_i), in closed form."""
        d = x.reshape(-1)[None, :] - p["z"].reshape(-1)[:, None]
        return kernels.dk_dr(kind, d, p["variance"], p["lengthscale"])

    def dKuf_dx2(self, kind: str, p: Params, x: torch.Tensor) -> torch.Tensor:
        """Cov(f(z_i), ∂²f(x_n)) = k″(x_n − z_i), in closed form."""
        d = x.reshape(-1)[None, :] - p["z"].reshape(-1)[:, None]
        return -kernels.neg_d2k_dr2(kind, d, p["variance"], p["lengthscale"])


@dataclass(frozen=True)
class FourierFeature(AxisFeature):
    """Variational Fourier features on [a, b] (VFF): ω_j = 2πj/(b − a),
    features [cos_0 … cos_M, sin_1 … sin_M] (m = 2M + 1), Kuu the diagonal
    plus low-rank form of :meth:`kuu_diag_lowrank`."""

    n_frequencies: int
    a: float
    b: float
    _cache: dict = field(default_factory=dict, init=False, repr=False, compare=False)

    @property
    def m(self) -> int:
        return 2 * self.n_frequencies + 1

    def omegas(self, like: torch.Tensor) -> torch.Tensor:
        """The M + 1 frequencies 2πj/(b − a), in ``like``'s dtype and on its
        device."""
        return self._constant("omegas", (2.0 * np.pi) * np.arange(self.n_frequencies + 1)
                              / (self.b - self.a), like)

    def kuu_diag_rank1(self, kind: str, p: Params):
        """(α, β) of Kuu = diag(α) + ββᵀ, Matérn-1/2 only."""
        if kind != "matern12":
            raise NotImplementedError("rank-1 VFF Kuu only for matern12; use kuu_diag_lowrank")
        alpha, W = self.kuu_diag_lowrank(kind, p)
        return alpha, W[:, 0]

    def kuu_diag_lowrank(self, kind: str, p: Params):
        """(α, W) of Kuu = diag(α) + W Wᵀ for Matérn-1/2, 3/2 and 5/2, from
        the Markov-state form of the interval RKHS inner product: the
        integral term is diagonal over the harmonics, (T/2)/S(ω_j) with the
        j = 0 cosine doubled; the boundary term is the low-rank part, with
        x_j = (ω_j/λ)²:

        - 1/2: rank 1, β = 1/σ on cos;
        - 3/2: rank 2, β₁ = 1/σ on cos, β₂ = ω/(σλ) on sin;
        - 5/2: rank 3, β₁ = (3 − x)/(√8σ) and β₂ = x/σ on cos,
          β₃ = √3·ω/(σλ) on sin.
        """
        om = self.omegas(p["lengthscale"])
        s_inv = 1.0 / kernels.spectral_density(kind, om, p["variance"], p["lengthscale"])
        alpha = (self.b - self.a) / 2.0 * torch.cat([2.0 * s_inv[:1], s_inv[1:], s_inv[1:]])
        sigma = torch.sqrt(p["variance"])
        zc, zs = torch.zeros_like(om), torch.zeros_like(om[1:])
        if kind == "matern12":
            cols = [torch.cat([torch.ones_like(om) / sigma, zs])]
        elif kind in ("matern32", "matern52"):
            lmbda = kernels.lam(kind, p["lengthscale"])
            b_sin = om[1:] / (sigma * lmbda)
            if kind == "matern32":
                cols = [torch.cat([torch.ones_like(om) / sigma, zs]), torch.cat([zc, b_sin])]
            else:
                x = (om / lmbda) ** 2
                cols = [torch.cat([(3.0 - x) / (sigma * math.sqrt(8.0)), zs]),
                        torch.cat([x / sigma, zs]),
                        torch.cat([zc, math.sqrt(3.0) * b_sin])]
        else:
            raise NotImplementedError(f"VFF Kuu closed form for {kind}")
        return alpha, torch.stack(cols, dim=1)

    def Kuu(self, kind: str, p: Params) -> torch.Tensor:
        return diag_lowrank.diag_lowrank_dense(*self.kuu_diag_lowrank(kind, p))

    def Kuf(self, kind: str, p: Params, x: torch.Tensor) -> torch.Tensor:
        """The basis Φ(x), (m, n): cos(ω(x − a)) and sin(ω(x − a)) inside
        [a, b); outside, the Matérn-order Markov continuation, decaying with
        r = min(|x − a|, |x − b|). The sin continuation carries +ωr e^{−λr}
        past b and −ωr e^{−λr} before a (extrapolating backwards flips the
        derivative term); the reference's ``fourier.py`` has the opposite
        sign and, for 5/2, ½(λ² + ω²r²) in place of ½(λ² − ω²)r², both
        discontinuous at the boundary and not copied."""
        x = x.reshape(-1)
        om = self.omegas(x)
        inside = ((x >= self.a) & (x < self.b))[None, :]
        xr = x - self.a
        cos_in = torch.cos(om[:, None] * xr[None, :])
        sin_in = torch.sin(om[1:, None] * xr[None, :])
        r = torch.minimum(torch.abs(x - self.a), torch.abs(x - self.b))
        s = torch.where(x < self.a, -1.0, 1.0)
        lmbda = kernels.lam(kind, p["lengthscale"])
        e = torch.exp(-lmbda * r)
        if kind == "matern12":
            cos_out = e[None, :]
            sin_out = torch.zeros_like(sin_in)
        elif kind == "matern32":
            cos_out = ((1.0 + lmbda * r) * e)[None, :]
            sin_out = (s * r * e)[None, :] * om[1:, None]
        elif kind == "matern52":
            # e^{Fr} of (d/dt + λ)³ on the edge state (1, 0 or ±ω, −ω² or 0)
            cos_out = (1.0 + lmbda * r[None, :]
                       + 0.5 * (lmbda ** 2 - om[:, None] ** 2) * r[None, :] ** 2) * e[None, :]
            sin_out = (s * r * (1.0 + lmbda * r) * e)[None, :] * om[1:, None]
        else:
            raise NotImplementedError(f"Fourier basis continuation for {kind}")
        return torch.cat([torch.where(inside, cos_in, cos_out),
                          torch.where(inside, sin_in, sin_out)], dim=0)

    def _tail_integrals(self, kind: str, lam, om, r0, h):
        """∫ of the Markov continuation over r ∈ [r0, r0 + h] ((g, 1) each):
        the cos block (g, M + 1), the ω = 0 constant as column 0, and the
        unsigned sin block (g, M). The moments ∫ rⁿ e^{−λr} go through
        γ(n + 1, ·) (``ops.stablemath``): the direct antiderivative
        differences cancel like (λh)ⁿ⁺¹ on short cells."""
        x = lam * h
        e0 = torch.exp(-lam * r0)
        i0 = e0 * (-expm1s(-x)) / lam                 # ∫ e^{−λr}
        j1 = e0 * gamma2_lower(x) / (lam * lam)       # ∫ (r − r0) e^{−λr}
        i1 = r0 * i0 + j1                             # ∫ r e^{−λr}
        if kind == "matern12":
            cos_t = i0.expand(-1, om.shape[0])
            sin_t = torch.zeros((r0.shape[0], om.shape[0] - 1), dtype=r0.dtype,
                                device=r0.device)
        elif kind == "matern32":
            cos_t = (i0 + lam * i1).expand(-1, om.shape[0])
            sin_t = om[None, 1:] * i1
        else:
            k2 = e0 * gamma3_lower(x) / lam ** 3
            i2 = r0 * r0 * i0 + 2.0 * r0 * j1 + k2    # ∫ r² e^{−λr}
            cos_t = i0 + lam * i1 + 0.5 * (lam * lam - om[None, :] ** 2) * i2
            sin_t = om[None, 1:] * (i1 + lam * i2)
        return cos_t, sin_t

    def Kvu(self, kind: str, p: Params, grid: "CellIntegralFeature") -> torch.Tensor:
        """Cell integrals of the basis, (g, m), inside and outside [a, b]:
        inside ∫1 = the overlap, ∫cos = (sin(ω(β − a)) − sin(ω(α − a)))/ω,
        ∫sin = −(cos(ω(β − a)) − cos(ω(α − a)))/ω; a cell reaching past
        [a, b] adds the integrals of the continuation (:meth:`Kuf`) over its
        left and right tails. A grid inside [a, b] skips them (a static
        check of its mesh)."""
        mesh = grid.mesh_j(p)
        om = self.omegas(mesh)
        al, be = mesh[:-1, None], mesh[1:, None]
        ai = torch.clamp(al, self.a, self.b) - self.a
        bi = torch.clamp(be, self.a, self.b) - self.a
        col0 = bi - ai
        w = om[None, 1:]
        cos_int = (torch.sin(w * bi) - torch.sin(w * ai)) / w
        sin_int = -(torch.cos(w * bi) - torch.cos(w * ai)) / w
        if grid.mesh[0] < self.a - 1e-12 or grid.mesh[-1] > self.b + 1e-12:
            if kind not in ("matern12", "matern32", "matern52"):
                raise NotImplementedError(
                    f"FourierFeature.Kvu outside [a, b] needs the Markov continuation, "
                    f"defined for Matérn kinds only (got {kind!r})")
            lam = kernels.lam(kind, p["lengthscale"])
            # right tail x = b + r; left tail x = a − r (dx = −dr, and s = −1 flips sin)
            cos_r, sin_r = self._tail_integrals(
                kind, lam, om, torch.clamp(al - self.b, min=0.0),
                torch.clamp(be - torch.clamp(al, min=self.b), min=0.0))
            cos_l, sin_l = self._tail_integrals(
                kind, lam, om, torch.clamp(self.a - be, min=0.0),
                torch.clamp(torch.clamp(be, max=self.a) - al, min=0.0))
            col0 = col0 + cos_r[:, :1] + cos_l[:, :1]
            cos_int = cos_int + cos_r[:, 1:] + cos_l[:, 1:]
            sin_int = sin_int + sin_r - sin_l
        return torch.cat([col0, cos_int, sin_int], dim=1)


def _require_uniform_mesh(mesh: np.ndarray, who: str) -> None:
    """Reject a non-uniform mesh where Kuu is built from the first spacing."""
    if len(mesh) < 2:
        raise ValueError(f"{who}: mesh needs at least 2 points, got {len(mesh)}")
    d = np.diff(mesh)
    if not np.all(d > 0):
        raise ValueError(f"{who}: mesh must be strictly increasing")
    if not np.allclose(d, d[0], rtol=1e-8, atol=1e-12 * abs(mesh[-1] - mesh[0])):
        raise ValueError(
            f"{who}: mesh must be uniformly spaced (Kuu is built from the first spacing "
            f"only); got spacings in [{d.min():.3e}, {d.max():.3e}]")


def _b1_segments(mesh: np.ndarray):
    """Static (tl, tc, tr) of the B1 hats over ``mesh``: a left half-hat,
    len(mesh) − 2 interior hats and a right half-hat (a degenerate segment,
    tl == tc or tc == tr, encodes a half)."""
    mesh = np.asarray(mesh, dtype=np.float64)
    tl = np.concatenate([[mesh[0]], mesh[:-2], [mesh[-2]]])
    tc = np.concatenate([[mesh[0]], mesh[1:-1], [mesh[-1]]])
    tr = np.concatenate([[mesh[1]], mesh[2:], [mesh[-1]]])
    return tl, tc, tr


@dataclass(frozen=True)
class B1SplineFeature(AxisFeature):
    """B1 (hat) spline RKHS features on a uniform mesh (ASVGP). Kuu is the
    tridiagonal Matérn-1/2 RKHS Gram (ℓ·B + A/ℓ + BC)/(2σ²) with the mass
    matrix A (∫φφ), the stiffness B (∫φ′φ′) and the boundary diagonal BC;
    the reference swaps ℓ and 1/ℓ, which is not copied."""

    mesh: np.ndarray  # (n_knots,) uniform
    _cache: dict = field(default_factory=dict, init=False, repr=False, compare=False)

    def __post_init__(self):
        mesh = np.asarray(self.mesh, dtype=np.float64)
        _require_uniform_mesh(mesh, "B1SplineFeature")
        object.__setattr__(self, "mesh", mesh)

    @property
    def m(self) -> int:
        return len(self.mesh)

    @property
    def delta(self) -> float:
        return float(self.mesh[1] - self.mesh[0])

    def _ends(self) -> np.ndarray:
        ends = np.zeros(self.m)
        ends[[0, -1]] = 1.0
        return ends

    def _mass_stiff_bc(self):
        """Static numpy A, B and BC: Toeplitz rows with boundary corrections."""
        m, d = self.m, self.delta
        k = np.abs(np.arange(m)[:, None] - np.arange(m)[None, :])
        ends = self._ends()
        mass = np.select([k == 0, k == 1], [2.0 * d / 3.0, d / 6.0], 0.0)
        stiff = np.select([k == 0, k == 1], [2.0 / d, -1.0 / d], 0.0)
        return (mass + np.diag(ends * (-d / 3.0)), stiff + np.diag(ends * (-1.0 / d)),
                np.diag(ends))

    def Kuu(self, kind: str, p: Params) -> torch.Tensor:
        if kind != "matern12":
            raise NotImplementedError("B1-spline RKHS Kuu implemented for matern12")
        ls, var = p["lengthscale"], p["variance"]
        A, B, BC = (self._constant(name, M, ls)
                    for name, M in zip(("A", "B", "BC"), self._mass_stiff_bc()))
        return (ls * B + A / ls + BC) / (2.0 * var)

    def kuu_bands(self, kind: str, p: Params) -> torch.Tensor:
        """(2, m) LAPACK-style bands of :meth:`Kuu`, for O(m) matvecs."""
        if kind != "matern12":
            raise NotImplementedError("B1-spline RKHS Kuu implemented for matern12")
        ls, var = p["lengthscale"], p["variance"]
        m, d = self.m, self.delta
        diag = (ls * (2.0 / d) + (2.0 * d / 3.0) / ls) * self._constant("ones", np.ones(m), ls)
        diag = diag + (ls * (-1.0 / d) + (-d / 3.0) / ls + 1.0) * self._constant(
            "ends", self._ends(), ls)
        off = (ls * (-1.0 / d) + (d / 6.0) / ls) * self._constant(
            "off", 1.0 - np.eye(m)[-1], ls)
        return torch.stack([diag, off]) / (2.0 * var)

    def kuu_matvec(self, kind: str, p: Params, v: torch.Tensor) -> torch.Tensor:
        """Kuu @ v by the banded matvec, O(m)."""
        return self.kuu_operator(kind, p)(v)

    def kuu_operator(self, kind: str, p: Params):
        from vggp_tpu_torch.ops import banded

        bands = self.kuu_bands(kind, p)
        return lambda v: banded.banded_matvec(bands, v)

    def kuu_diag(self, kind: str, p: Params) -> torch.Tensor:
        return self.kuu_bands(kind, p)[0]

    def Kuf(self, kind: str, p: Params, x: torch.Tensor) -> torch.Tensor:
        """The hats Φ(x), (m, n); a half-hat's down-ramp includes its left end."""
        x = x.reshape(-1)
        tl_np, tc_np, tr_np = _b1_segments(self.mesh)
        has_up_np, has_down_np = tc_np > tl_np, tr_np > tc_np
        tl, tc, tr = (self._constant(n, t, x)[:, None]
                      for n, t in (("tl", tl_np), ("tc", tc_np), ("tr", tr_np)))
        up_den = self._constant("up_den", np.where(has_up_np, tc_np - tl_np, 1.0), x)[:, None]
        down_den = self._constant("down_den", np.where(has_down_np, tr_np - tc_np, 1.0),
                                  x)[:, None]
        has_up = torch.as_tensor(has_up_np, device=x.device)[:, None]
        has_down = torch.as_tensor(has_down_np, device=x.device)[:, None]
        xt = x[None, :]
        up = (xt - tl) / up_den
        down = (tr - xt) / down_den
        in_up = has_up & (xt >= tl) & (xt <= tc)
        in_down = has_down & (xt > tc) & (xt <= tr)
        in_down_l = has_down & ~has_up & (xt == tc)
        return torch.where(in_up, up, 0.0) + torch.where(in_down | in_down_l, down, 0.0)

    def Kvu(self, kind: str, p: Params, grid: "CellIntegralFeature") -> torch.Tensor:
        """Exact integrals of each hat over each grid cell, (g, m), for any
        alignment of the knots and the cells (closed-form ramp integrals)."""
        mesh = grid.mesh_j(p)
        tl, tc, tr = (self._constant(n, t, mesh)[None, :]
                      for n, t in zip(("tl", "tc", "tr"), _b1_segments(self.mesh)))
        a, b = mesh[:-1, None], mesh[1:, None]

        def ramp(t0, t1, up):
            # ∫ over [a, b] ∩ [t0, t1] of (x − t0)/(t1 − t0), or of (t1 − x)/(t1 − t0)
            den = torch.where(t1 > t0, t1 - t0, 1.0)
            lo = torch.minimum(torch.maximum(a, t0), t1)
            hi = torch.minimum(torch.maximum(b, t0), t1)
            val = (((hi - t0) ** 2 - (lo - t0) ** 2) if up
                   else ((t1 - lo) ** 2 - (t1 - hi) ** 2)) / (2.0 * den)
            return torch.where(t1 > t0, val, 0.0)

        return ramp(tl, tc, True) + ramp(tc, tr, False)


# Matérn order matched to spline smoothness: degree-p splines are C^{p−1},
# in H_ν for ν = p − 1/2 (the ASVGP order prescription).
_SPLINE_KIND_BY_DEGREE = {2: "matern32", 3: "matern52"}


@dataclass(frozen=True)
class SplineRKHSFeature(AxisFeature):
    """B-spline RKHS features of degree 2 (Matérn-3/2) or 3 (Matérn-5/2),
    ASVGP beyond the reference's B1 hats: open-clamped uniform knots on
    [a, b] with K intervals, m = K + p functions.

    Kuu is the Markov-state form of the interval RKHS inner product, with
    L = (d/dt + λ)^p and c the white-noise intensity of S(ω) = c/(λ² + ω²)^p:
    ⟨φᵢ, φⱼ⟩ = (1/c)·Σ_{r,s≤p} C(p,r)C(p,s) λ^{2p−r−s} ∫φᵢ^(r)φⱼ^(s)
    + state_i(a)ᵀ P₀⁻¹ state_j(a). The ∫φ^(r)φ^(s) are static banded
    integrals, exact by Gauss–Legendre at construction, so Kuu is a
    polynomial in λ. Kuf evaluates the piecewise polynomials branch-free
    from a static coefficient table; Kvu is a static table of exact spline
    antiderivatives.
    """

    degree: int
    n_intervals: int
    a: float
    b: float
    _cache: dict = field(default_factory=dict, init=False, repr=False, compare=False)

    def __post_init__(self):
        if self.degree not in _SPLINE_KIND_BY_DEGREE:
            raise ValueError("SplineRKHSFeature supports degree 2 or 3")
        if self.n_intervals < self.degree:
            raise ValueError("need n_intervals >= degree")
        from scipy.interpolate import BSpline

        deg, K, a, b = self.degree, self.n_intervals, self.a, self.b
        delta = (b - a) / K
        interior = np.linspace(a, b, K + 1)
        T = np.concatenate([[a] * deg, interior, [b] * deg])  # open-clamped
        m = K + deg
        splines = [BSpline(T, np.eye(m)[j], deg, extrapolate=False) for j in range(m)]
        derivs = [[s.derivative(r) if r else s for r in range(deg + 1)] for s in splines]
        # Gauss–Legendre with deg + 1 points per interval: exact to degree 2·deg + 1
        gl_x, gl_w = np.polynomial.legendre.leggauss(deg + 1)
        M = np.zeros((deg + 1, deg + 1, m, m))
        for i in range(K):
            lo, hi = interior[i], interior[i + 1]
            xs = 0.5 * (hi - lo) * gl_x + 0.5 * (hi + lo)
            ws = 0.5 * (hi - lo) * gl_w
            act = range(i, min(m, i + deg + 1))  # the bases active on interval i
            V = {(j, r): np.nan_to_num(derivs[j][r](xs)) for j in act for r in range(deg + 1)}
            for j in act:
                for k in act:
                    for r in range(deg + 1):
                        for s in range(deg + 1):
                            M[r, s, j, k] += np.sum(ws * V[(j, r)] * V[(k, s)])
        eps = 1e-12 * (b - a)
        state = np.stack([np.array([float(np.nan_to_num(derivs[j][r](a + eps)))
                                    for j in range(m)]) for r in range(deg)])  # φ^(r)(a)
        # per-interval coefficients C[i, s, :] in u = (x − a)/δ − i ∈ [0, 1],
        # recovered exactly by interpolation at deg + 1 nodes
        C = np.zeros((K, deg + 1, deg + 1))
        nodes = np.linspace(1e-9, 1 - 1e-9, deg + 1)
        vander = np.vander(nodes, deg + 1, increasing=True)
        for i in range(K):
            pts = a + i * delta + delta * nodes
            for s in range(deg + 1):
                if i + s < m:
                    vals = np.array([float(np.nan_to_num(splines[i + s](t))) for t in pts])
                    C[i, s] = np.linalg.solve(vander, vals)
        object.__setattr__(self, "_M", M)
        object.__setattr__(self, "_state", state)
        object.__setattr__(self, "_coeffs", C)
        object.__setattr__(self, "_splines", tuple(splines))
        object.__setattr__(self, "delta", delta)

    @property
    def m(self) -> int:
        return self.n_intervals + self.degree

    @property
    def kind(self) -> str:
        return _SPLINE_KIND_BY_DEGREE[self.degree]

    def Kuu(self, kind: str, p: Params) -> torch.Tensor:
        want = self.kind
        if kind != want:
            raise NotImplementedError(
                f"degree-{self.degree} spline RKHS Kuu pairs with {want} "
                f"(C^{self.degree - 1} splines live in H_{{{want[-2]}/{want[-1]}}})")
        ls, var = p["lengthscale"], p["variance"]
        lam = kernels.lam(kind, ls)
        deg = self.degree
        integral = torch.zeros((self.m, self.m), dtype=ls.dtype, device=ls.device)
        for r in range(deg + 1):
            for s in range(deg + 1):
                w = math.comb(deg, r) * math.comb(deg, s)
                integral = integral + (w * lam ** (2 * deg - r - s)) * self._constant(
                    f"M{r}{s}", self._M[r, s], ls)
        out = integral / kernels.white_noise_intensity(kind, var, ls)
        pinv = kernels.p0_inv_rows(kind, var, ls)
        for r in range(deg):
            for s in range(deg):
                if isinstance(pinv[r][s], float) and pinv[r][s] == 0.0:
                    continue
                out = out + pinv[r][s] * torch.outer(
                    self._constant(f"state{r}", self._state[r], ls),
                    self._constant(f"state{s}", self._state[s], ls))
        return out

    def Kuf(self, kind: str, p: Params, x: torch.Tensor) -> torch.Tensor:
        """The piecewise polynomials Φ(x), (m, n), branch-free."""
        x = x.reshape(-1)
        K, deg = self.n_intervals, self.degree
        t = (x - self.a) / self.delta
        i = torch.clamp(torch.floor(t), 0, K - 1).to(torch.int64)
        u = t - i
        ci = self._constant("coeffs", self._coeffs, x)[i]           # (n, deg+1, deg+1)
        upow = torch.stack([u ** k for k in range(deg + 1)], dim=1)  # (n, deg+1)
        vals = torch.einsum("nsc,nc->ns", ci, upow)
        rows = torch.arange(self.m, device=x.device)[:, None]
        inside = ((x >= self.a) & (x <= self.b))[None, :]
        out = torch.zeros((self.m, x.shape[0]), dtype=x.dtype, device=x.device)
        for s in range(deg + 1):
            out = out + torch.where((rows == (i + s)[None, :]) & inside, vals[:, s][None, :], 0.0)
        return out

    def Kvu(self, kind: str, p: Params, grid: "CellIntegralFeature") -> torch.Tensor:
        """Exact integrals of each spline over each grid cell: a static table
        of antiderivatives at the clipped cell edges."""
        mesh = np.asarray(grid.mesh)
        lo, hi = np.clip(mesh[:-1], self.a, self.b), np.clip(mesh[1:], self.a, self.b)
        tbl = np.zeros((len(mesh) - 1, self.m))
        for j, s in enumerate(self._splines):
            A = s.antiderivative()
            tbl[:, j] = np.nan_to_num(A(hi)) - np.nan_to_num(A(lo))
        ls = p["lengthscale"]
        return torch.as_tensor(tbl, dtype=ls.dtype, device=ls.device)


def B2SplineFeature(n_intervals: int, a: float, b: float) -> SplineRKHSFeature:
    """Quadratic-spline ASVGP features (Matérn-3/2)."""
    return SplineRKHSFeature(2, n_intervals, a, b)


def B3SplineFeature(n_intervals: int, a: float, b: float) -> SplineRKHSFeature:
    """Cubic-spline ASVGP features (Matérn-5/2)."""
    return SplineRKHSFeature(3, n_intervals, a, b)


@dataclass(frozen=True)
class CellIntegralFeature(AxisFeature):
    """B0 cell-integral features v_i = ∫_{[mesh_i, mesh_{i+1}]} f(t) dt."""

    mesh: np.ndarray  # (n_cells + 1,) strictly increasing cell edges
    # device copies of the mesh by (dtype, device): no host-to-device copy per step
    _meshes: dict = field(default_factory=dict, init=False, repr=False, compare=False)

    def __post_init__(self):
        mesh = np.asarray(self.mesh, dtype=np.float64)
        if len(mesh) < 2:
            raise ValueError(
                f"CellIntegralFeature: mesh needs at least 2 points, got {len(mesh)}")
        d = np.diff(mesh)
        if not np.all(d > 0):
            raise ValueError("CellIntegralFeature: mesh must be strictly increasing")
        # only the Toeplitz and closed-form-F⁻¹ lanes need a uniform mesh
        uniform = bool(np.allclose(d, d[0], rtol=1e-8,
                                   atol=1e-12 * abs(mesh[-1] - mesh[0])))
        object.__setattr__(self, "mesh", mesh)
        object.__setattr__(self, "uniform", uniform)

    @classmethod
    def from_lims(cls, n_cells: int, a: float, b: float) -> "CellIntegralFeature":
        return cls(np.linspace(a, b, n_cells + 1))

    @property
    def m(self) -> int:
        return len(self.mesh) - 1

    @property
    def delta(self) -> float:
        """Cell width of a uniform mesh (read only where ``self.uniform``)."""
        return float(self.mesh[1] - self.mesh[0])

    def mesh_j(self, p: Params) -> torch.Tensor:
        ell = p["lengthscale"]
        return _cached(self._meshes, (ell.dtype, ell.device),
                       lambda: torch.as_tensor(self.mesh, dtype=ell.dtype, device=ell.device))

    def Kuu(self, kind: str, p: Params) -> torch.Tensor:
        """(m, m): the Toeplitz matrix of :meth:`kuu_first_row` on a uniform
        mesh; on any other the dense Gram, for Matérn-1/2 in the product form
        of :func:`_m12_cell_gram`, else the compensated cell/cell form."""
        if not self.uniform:
            mesh = self.mesh_j(p)
            if kind == "matern12":
                return _m12_cell_gram(mesh, p["variance"], p["lengthscale"])
            return _cell_cell_cov(kind, mesh, mesh, p["variance"], p["lengthscale"])
        return toeplitz.sym_toeplitz_dense(self.kuu_first_row(kind, p))

    def kuu_first_row(self, kind: str, p: Params) -> torch.Tensor:
        if not self.uniform:
            raise ValueError("kuu_first_row is Toeplitz-only (uniform mesh); use Kuu()")
        v, ell = p["variance"], p["lengthscale"]
        if kind == "matern12":
            return _m12_toeplitz_first_row(self.m, self.delta, v, ell, ell.dtype)
        if kind in ("matern32", "matern52"):
            return _cell_toeplitz_first_row(kind, self.m, self.delta, v, ell, ell.dtype)
        if kind == "rbf":
            return _rbf_toeplitz_first_row(self.m, self.delta, v, ell, ell.dtype)
        mesh = self.mesh_j(p)
        return _cell_cell_cov(kind, mesh, mesh[:2], v, ell)[:, 0]

    def kuu_first_row_dl(self, kind: str, p: Params):
        """∂/∂ℓ of :meth:`kuu_first_row` in closed form (Matérn-1/2 on a
        uniform mesh), or None: the caller then takes a forward-mode
        tangent of :meth:`Kuu`."""
        if kind != "matern12" or not self.uniform:
            return None
        ell = p["lengthscale"]
        return _m12_toeplitz_first_row_dl(self.m, self.delta, p["variance"], ell, ell.dtype)

    def kuu_matvec(self, kind: str, p: Params, v: torch.Tensor) -> torch.Tensor:
        """Kuu @ v, ``v`` (m,) or (m, k): the FFT Toeplitz matvec of
        :meth:`kuu_first_row` on a uniform mesh, O(m log m) with no (m, m)
        Gram; the dense product on any other mesh."""
        return self.kuu_operator(kind, p)(v)

    def kuu_operator(self, kind: str, p: Params):
        if not self.uniform:
            return super().kuu_operator(kind, p)
        return toeplitz.sym_toeplitz_operator(self.kuu_first_row(kind, p))

    def kuu_diag(self, kind: str, p: Params) -> torch.Tensor:
        """diag(Kuu): the constant first-row[0] on a uniform mesh, the
        per-cell self-covariances otherwise."""
        if not self.uniform:
            return torch.diagonal(self.Kuu(kind, p))
        row = self.kuu_first_row(kind, p)
        return row[0].expand(self.m)

    def extra_f32_jitter(self, kind: str) -> float:
        """Per-kind float32 jitter floor on top of ``common.KIND_JITTER_F32``:
        2e-4 for the Matérn-3/2, 5/2 and RBF cell Grams, whose λ_min sits
        close to the generic 1e-4 floor (the JAX package's measurement)."""
        return 2e-4 if kind in ("matern32", "matern52", "rbf") else 0.0

    def inv_chol_kuu(self, kind: str, p: Params, rel_jitter: float):
        """Closed-form F⁻¹ of the relative-jittered Kuu Cholesky (``ops.kms``)
        for Matérn-1/2 on a uniform mesh, else None (the dense factor)."""
        if kind != "matern12" or not self.uniform:
            return None
        from vggp_tpu_torch.ops.kms import m12_cell_inv_chol

        return m12_cell_inv_chol(self.m, self.delta, p["variance"], p["lengthscale"],
                                 rel_jitter)

    def whiten_band_ratio(self, kind: str, p: Params, rel_jitter: float):
        """Geometric decay ratio of the structured F⁻¹ (``ops.kms``), or None
        where no banded structure is known."""
        if kind != "matern12" or not self.uniform:
            return None
        from vggp_tpu_torch.ops.kms import m12_geometric_ratio

        return m12_geometric_ratio(self.delta, p["lengthscale"], rel_jitter)

    def inv_chol_kuu_and_ratio(self, kind: str, p: Params, rel_jitter: float):
        """Both of the above from one ``ops.kms.m12_finv`` (on the card one
        launch of its kernel), or None off Matérn-1/2 on a uniform mesh."""
        if kind != "matern12" or not self.uniform:
            return None
        from vggp_tpu_torch.ops.kms import m12_cell_inv_chol_and_ratio

        return m12_cell_inv_chol_and_ratio(self.m, self.delta, p["variance"],
                                           p["lengthscale"], rel_jitter)

    @traced("vggp.dispatch.kuf")
    def Kuf(self, kind: str, p: Params, x: torch.Tensor) -> torch.Tensor:
        """(m, n) cross-covariance, differentiable in σ² and ℓ: the
        ``cell_kuf`` kernel for Matérn-1/2 on any mesh, plain torch for the
        other kinds."""
        x = x.reshape(-1)
        if kind == "matern12":
            return ck.cell_kuf_op(self.mesh_j(p), x.contiguous(), p["variance"],
                                  p["lengthscale"])
        return _cell_point_cov(kind, self.mesh_j(p), x, p["variance"], p["lengthscale"])

    def Kvu(self, kind: str, p: Params, grid: "CellIntegralFeature") -> torch.Tensor:
        """(g, m) Cov[v, u] between the cells of ``grid`` and these features:
        the generic compensated cell/cell form."""
        return _cell_cell_cov(kind, grid.mesh_j(p), self.mesh_j(p), p["variance"],
                              p["lengthscale"])

    @traced("vggp.dispatch.kuf")
    def Kuf_with_dl(self, kind: str, p: Params, x: torch.Tensor):
        """(Kuf, ∂Kuf/∂ℓ) as values: one ``cell_kuf_with_dl`` pass for
        Matérn-1/2 on any mesh, the forward-mode tangent of :meth:`Kuf` in ℓ
        for the other kinds."""
        x = x.reshape(-1)
        if kind == "matern12":
            return ck.cell_kuf_with_dl(self.mesh_j(p), x.contiguous(), p["variance"],
                                       p["lengthscale"])
        return super().Kuf_with_dl(kind, p, x)

    def whitened_kuf_fused(self, kind: str, p: Params, finv, ratio, x):
        """(a, t) = (F⁻¹Kuf, F⁻¹∂Kuf/∂ℓ) in one fused kernel pass, or None
        when the fusion does not apply (another kind than Matérn-1/2, no band
        ratio, as on a non-uniform mesh, a batch below the fusion minimum, or
        a mesh that does not block into ≥ 2 bands). ``t`` rides
        ``config.MATMUL_PRECISION``, as the rest of the ℓ-tangent
        (``models.common._whitened_kuf_tangent``).

        At or above the ``ratio < 0.7`` gate the factor is not banded: the
        unfused pass and two dense products are taken instead. The gate is
        ``ops.kms.below_band_gate``, a read back to the host.
        """
        from vggp_tpu_torch.ops.kms import BAND_BLOCK, below_band_gate

        x = x.reshape(-1).contiguous()
        n = x.shape[0]
        if (kind != "matern12" or ratio is None or not config.fused_whiten_enabled(n)
                or self.m % BAND_BLOCK != 0 or self.m // BAND_BLOCK < 2):
            return None
        mesh = self.mesh_j(p)
        v, ell = p["variance"], p["lengthscale"]
        if below_band_gate(ratio):
            with span("vggp.dispatch.whiten"):
                return ck.fused_banded_whiten_kuf(finv, mesh, x, v, ell,
                                                  config.WHITEN_MATMUL_PRECISION,
                                                  config.MATMUL_PRECISION)
        with span("vggp.dispatch.kuf"):
            kuf, dkuf = ck.cell_kuf_with_dl(mesh, x, v, ell)
        with span("vggp.dispatch.whiten"), \
                config.matmul_precision(config.WHITEN_MATMUL_PRECISION):
            a = finv @ kuf
        with span("vggp.dispatch.tangent"), config.matmul_precision(config.MATMUL_PRECISION):
            t = finv @ dkuf
        return a, t

    def dKuf_dx(self, kind: str, p: Params, x: torch.Tensor) -> torch.Tensor:
        """Cov(v_i, ∂f(x)) = k(x − α_i) − k(x − β_i): a kernel-value
        difference, exact for every kind."""
        x = x.reshape(-1)
        mesh = self.mesh_j(p)
        ka = kernels.gram_1d(kind, mesh[:-1], x, p["variance"], p["lengthscale"])
        kb = kernels.gram_1d(kind, mesh[1:], x, p["variance"], p["lengthscale"])
        return ka - kb

    def dKuf_dx2(self, kind: str, p: Params, x: torch.Tensor) -> torch.Tensor:
        """Cov(v_i, ∂²f(x)) = k′(x − α_i) − k′(x − β_i), in closed form."""
        x = x.reshape(-1)[None, :]
        mesh = self.mesh_j(p)
        da = kernels.dk_dr(kind, x - mesh[:-1, None], p["variance"], p["lengthscale"])
        db = kernels.dk_dr(kind, x - mesh[1:, None], p["variance"], p["lengthscale"])
        return da - db

    def basis_eval(self, x: torch.Tensor) -> torch.Tensor:
        """The B0 indicator basis, (m, n): half-open cells [a_i, b_i) and
        the last one closed, an exact partition of unity on the mesh (the
        reference's closed cells count an interior edge twice)."""
        x = x.reshape(-1)
        mesh = torch.as_tensor(self.mesh, dtype=x.dtype, device=x.device)
        a, b = mesh[:-1, None], mesh[1:, None]
        last = (torch.arange(self.m, device=x.device)[:, None] == self.m - 1) & (x[None, :] == b)
        return (((x[None, :] >= a) & (x[None, :] < b)) | last).to(x.dtype)


@dataclass(frozen=True)
class OutputFeature(AxisFeature):
    """The discrete output axis of a multi-output (ICM) model
    (``features.py:1393-1462``), paired with ``kind == "coregion"``. The axis
    coordinate is the output index p ∈ {0, …, P − 1}, carried as a float
    column of X; one inducing feature per output, so Kuu = B = W Wᵀ + diag(κ)
    (``kernels.coregion_b``), Kuf gathers B's columns and the joint prior is
    B ⊗ (⊗ K_axis). The gradient heads reject the axis through their
    differentiability checks.

    W starts from a fixed host generator (``default_rng(20260818)``, as in
    the JAX package, so both start from the same W); κ is positive under
    the softplus floor.
    """

    n_outputs: int
    rank: int = 1

    def __post_init__(self):
        if self.n_outputs < 1 or not 1 <= self.rank <= self.n_outputs:
            raise ValueError(
                f"OutputFeature: need n_outputs ≥ 1 and 1 ≤ rank ≤ n_outputs, "
                f"got ({self.n_outputs}, {self.rank})")

    @property
    def m(self) -> int:
        return self.n_outputs

    def init_params(self, dtype=torch.float32, device=None) -> Dict:
        """W ~ 0.5·N(0, 1) + 0.5 from the fixed generator, κ = 0.5, on
        ``cuda`` unless ``device`` is given."""
        device = config.resolve_device(device)
        w = 0.5 * np.random.default_rng(20260818).standard_normal((self.n_outputs, self.rank)) + 0.5
        return {"w": torch.as_tensor(w, dtype=dtype, device=device),
                "kappa": torch.full((self.n_outputs,), 0.5, dtype=dtype, device=device)}

    def _check_kind(self, kind: str) -> None:
        if kind != kernels.COREGION_KIND:
            raise ValueError(f"OutputFeature pairs with kind='coregion', got {kind!r}")

    def Kuu(self, kind: str, p: Params) -> torch.Tensor:
        self._check_kind(kind)
        return kernels.coregion_b(p)

    def Kuf(self, kind: str, p: Params, x: torch.Tensor) -> torch.Tensor:
        """(P, n): B's columns at the output indices, a column NaN where its
        index is not an integer in [0, P) (the index clipped before the
        gather: see ``kernels.clip_index``)."""
        self._check_kind(kind)
        idx, valid = kernels._as_index(x, self.n_outputs)
        B = kernels.coregion_b(p)
        return kernels._poison(B[:, kernels.clip_index(idx, self.n_outputs)], valid[None, :])

    def Kvu(self, kind: str, p: Params, grid: "OutputFeature") -> torch.Tensor:
        """B itself: the grid of an output axis is the outputs themselves
        (one product slice per output). Any other grid axis raises."""
        self._check_kind(kind)
        if not isinstance(grid, OutputFeature) or grid.n_outputs != self.n_outputs:
            raise ValueError(
                "OutputFeature.Kvu: the grid axis for an output axis must be "
                f"the same outputs (OutputFeature(n_outputs={self.n_outputs}))")
        return kernels.coregion_b(p)
