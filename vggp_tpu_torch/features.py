"""Inducing features of the port: the B0 cell-integral feature
(``vggp_tpu/features.py:1128-1352``) for the Matérn-1/2 kernel on a uniform
mesh — the main path's feature — with its cell/point (Kuf), cell/cell (Kuu,
and Kvu against the cells of a serving grid) covariances.

Other kernel kinds and non-uniform meshes raise ``NotImplementedError``
(ROADMAP queue 1, item 10).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

import numpy as np
import torch

from vggp_tpu_torch import config, kernels
from vggp_tpu_torch.ops import cell_kuf as ck
from vggp_tpu_torch.ops import toeplitz
from vggp_tpu_torch.ops.stablemath import expm1mx, expm1s

Params = Dict[str, torch.Tensor]

_NOT_PORTED = "(ROADMAP queue 1, item 10: the other features and model families)"


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


# The cell/cell columns of ``_CELL_COEFFS`` (``vggp_tpu/features.py:72-76``)
# for the one ported kind; the other Matérn orders come with their features
# (ROADMAP queue 1, item 10), and the cell/point columns g0–g2 have no caller.
#                 c_lin   c0    c1     c2
_CELL_COEFFS = {
    "matern12": (1.0,    1.0,  0.0,   0.0),
}


def _cell_cell_cov(kind: str, mesh_a, mesh_b, variance, lengthscale):
    """Cov[∫_{A_i} f, ∫_{B_j} f] for a Matérn order, compensated. (ga, gb).

    ``∬ k = Σ± P(|u|)`` over the four corner differences, with P the
    poly-exponential antiderivative; its linear part telescopes exactly to
    ``(c_lin/λ)·2·overlap`` and the decaying part is grouped into two
    compensated nearby-exponential differences (``features.py:178-207``).
    """
    c_lin, c0, c1, c2 = _CELL_COEFFS[kind]
    lam = kernels.lam(kind, lengthscale)
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
        """Cell width of the uniform mesh."""
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

    def _require_m12_uniform(self, kind: str) -> None:
        if kind != "matern12":
            raise NotImplementedError(
                f"CellIntegralFeature for kind {kind!r} is not ported yet {_NOT_PORTED}")
        if not self.uniform:
            raise NotImplementedError(
                f"CellIntegralFeature on a non-uniform mesh is not ported yet {_NOT_PORTED}")

    def Kuu(self, kind: str, p: Params) -> torch.Tensor:
        return toeplitz.sym_toeplitz_dense(self.kuu_first_row(kind, p))

    def kuu_first_row(self, kind: str, p: Params) -> torch.Tensor:
        self._require_m12_uniform(kind)
        ell = p["lengthscale"]
        return _m12_toeplitz_first_row(self.m, self.delta, p["variance"], ell, ell.dtype)

    def kuu_first_row_dl(self, kind: str, p: Params) -> torch.Tensor:
        """∂/∂ℓ of :meth:`kuu_first_row`."""
        self._require_m12_uniform(kind)
        ell = p["lengthscale"]
        return _m12_toeplitz_first_row_dl(self.m, self.delta, p["variance"], ell, ell.dtype)

    def inv_chol_kuu(self, kind: str, p: Params, rel_jitter: float) -> torch.Tensor:
        """Closed-form F⁻¹ of the relative-jittered Kuu Cholesky (``ops.kms``)."""
        self._require_m12_uniform(kind)
        from vggp_tpu_torch.ops.kms import m12_cell_inv_chol

        return m12_cell_inv_chol(self.m, self.delta, p["variance"], p["lengthscale"],
                                 rel_jitter)

    def whiten_band_ratio(self, kind: str, p: Params, rel_jitter: float) -> torch.Tensor:
        """Geometric decay ratio of the structured F⁻¹ (``ops.kms``)."""
        self._require_m12_uniform(kind)
        from vggp_tpu_torch.ops.kms import m12_geometric_ratio

        return m12_geometric_ratio(self.delta, p["lengthscale"], rel_jitter)

    def Kuf(self, kind: str, p: Params, x: torch.Tensor) -> torch.Tensor:
        """(m, n) cross-covariance, differentiable in σ² and ℓ, through the
        ``cell_kuf`` kernel."""
        self._require_m12_uniform(kind)
        return ck.cell_kuf_op(self.mesh_j(p), x.reshape(-1).contiguous(),
                              p["variance"], p["lengthscale"])

    def Kvu(self, kind: str, p: Params, grid: "CellIntegralFeature") -> torch.Tensor:
        """(g, m) Cov[v, u] between the cells of ``grid`` and these features:
        the generic compensated cell/cell form, as the JAX ``Kvu`` takes."""
        self._require_m12_uniform(kind)
        grid._require_m12_uniform(kind)
        return _cell_cell_cov(kind, grid.mesh_j(p), self.mesh_j(p), p["variance"],
                              p["lengthscale"])

    def Kuf_with_dl(self, kind: str, p: Params, x: torch.Tensor):
        """(Kuf, ∂Kuf/∂ℓ) as values, in one ``cell_kuf_with_dl`` pass."""
        self._require_m12_uniform(kind)
        return ck.cell_kuf_with_dl(self.mesh_j(p), x.reshape(-1).contiguous(),
                                   p["variance"], p["lengthscale"])

    def whitened_kuf_fused(self, kind: str, p: Params, finv, ratio, x):
        """(a, t) = (F⁻¹Kuf, F⁻¹∂Kuf/∂ℓ) in one fused kernel pass, or None
        when the fusion does not apply (batch below the fusion minimum, a
        mesh that does not block into ≥ 2 bands, or no band ratio). ``t``
        rides ``config.MATMUL_PRECISION``, as the rest of the ℓ-tangent
        (``models.common._whitened_kuf_tangent``).

        At or above the ``ratio < 0.7`` gate the factor is not banded: the
        unfused pass and two dense products are taken instead. The gate is a
        Python branch and reads ``ratio`` back to the host.
        """
        from vggp_tpu_torch.ops.kms import BAND_BLOCK

        self._require_m12_uniform(kind)
        x = x.reshape(-1).contiguous()
        n = x.shape[0]
        if (ratio is None or not config.fused_whiten_enabled(n)
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
