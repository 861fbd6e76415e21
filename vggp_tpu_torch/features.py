"""Inducing features of the port: the B0 cell-integral feature
(``vggp_tpu/features.py:1128-1374``) for the Matérn-1/2, 3/2, 5/2 and RBF
kernels on uniform and non-uniform meshes, with its cell/point (Kuf),
cell/cell (Kuu, and Kvu against the cells of a serving grid) covariances and
the cell/point derivative blocks of the gradient heads.

The Matérn-1/2 Kuf takes the ``cell_kuf`` kernels on any mesh; the other
kinds are plain torch, as the JAX package computes them in jnp.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict

import numpy as np
import torch

from vggp_tpu_torch import config, kernels
from vggp_tpu_torch.ops import cell_kuf as ck
from vggp_tpu_torch.ops import toeplitz
from vggp_tpu_torch.ops.stablemath import expm1mx, expm1s

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
    caches it fills (``mesh_j``, the GL-24 constants) stay usable after it."""
    import torch.autograd.forward_ad as fwAD

    with fwAD.dual_level():
        primal, tangent = fwAD.unpack_dual(fn(fwAD.make_dual(ell, torch.ones_like(ell))))
    if tangent is None:
        raise RuntimeError("forward-mode AD carried no tangent (is it off here, as inside "
                           "an autograd.Function's forward?)")
    return primal, tangent


@dataclass(frozen=True)
class CellIntegralFeature:
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

    def init_params(self, dtype=None) -> Dict:
        """Feature-owned learnable parameters: none for a fixed basis."""
        return {}

    def mesh_j(self, p: Params) -> torch.Tensor:
        ell = p["lengthscale"]
        key = (ell.dtype, ell.device)
        if key not in self._meshes:
            self._meshes[key] = torch.as_tensor(self.mesh, dtype=ell.dtype, device=ell.device)
        return self._meshes[key]

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

    def Kuf_with_dl(self, kind: str, p: Params, x: torch.Tensor):
        """(Kuf, ∂Kuf/∂ℓ) as values: one ``cell_kuf_with_dl`` pass for
        Matérn-1/2 on any mesh, the forward-mode tangent of :meth:`Kuf` in ℓ
        for the other kinds."""
        x = x.reshape(-1)
        if kind == "matern12":
            return ck.cell_kuf_with_dl(self.mesh_j(p), x.contiguous(), p["variance"],
                                       p["lengthscale"])
        return ell_tangent(lambda t: self.Kuf(kind, {**p, "lengthscale": t}, x),
                           p["lengthscale"])

    def whitened_kuf_fused(self, kind: str, p: Params, finv, ratio, x):
        """(a, t) = (F⁻¹Kuf, F⁻¹∂Kuf/∂ℓ) in one fused kernel pass, or None
        when the fusion does not apply (another kind than Matérn-1/2, no band
        ratio, as on a non-uniform mesh, a batch below the fusion minimum, or
        a mesh that does not block into ≥ 2 bands). ``t`` rides
        ``config.MATMUL_PRECISION``, as the rest of the ℓ-tangent
        (``models.common._whitened_kuf_tangent``).

        At or above the ``ratio < 0.7`` gate the factor is not banded: the
        unfused pass and two dense products are taken instead. The gate is a
        Python branch and reads ``ratio`` back to the host.
        """
        from vggp_tpu_torch.ops.kms import BAND_BLOCK

        x = x.reshape(-1).contiguous()
        n = x.shape[0]
        if (kind != "matern12" or ratio is None or not config.fused_whiten_enabled(n)
                or self.m % BAND_BLOCK != 0 or self.m // BAND_BLOCK < 2):
            return None
        mesh = self.mesh_j(p)
        v, ell = p["variance"], p["lengthscale"]
        if bool(ratio < 0.7):
            return ck.fused_banded_whiten_kuf(finv, mesh, x, v, ell,
                                              config.WHITEN_MATMUL_PRECISION,
                                              config.MATMUL_PRECISION)
        kuf, dkuf = ck.cell_kuf_with_dl(mesh, x, v, ell)
        with config.matmul_precision(config.WHITEN_MATMUL_PRECISION):
            a = finv @ kuf
        with config.matmul_precision(config.MATMUL_PRECISION):
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
