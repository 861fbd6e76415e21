"""Reference-style torch float64 oracle for apples-to-apples parity runs.

A verbatim copy of ``vggp_tpu/experiments/torch_oracle.py`` (only this
docstring differs): the port imports nothing of the JAX package. It is the
"reference-f64-CPU" column of :mod:`vggp_tpu_torch.experiments.parity` and
runs on the CPU in float64 by design — an independent reference, not a
fallback of the port.

The reference implementation (PyTorch/gpytorch class stack,
``src/models/sparse/*.py``) cannot run in this image — gpytorch and
linear_operator are not installed. This module is an INDEPENDENT torch f64
implementation of the same mathematics, matching the reference model-for-
model (same kernels, same inducing constructions, same training protocol:
``torch.optim.Adam``, nb61's N_ITER=1000 / LEARNING_RATE=0.01, softplus
positivity), used by the parity experiments as the
"reference-f64-CPU" column of the parity tables.

Model zoo (nb61 configuration, all Matérn-1/2, 2D separable):

- ``exactgp``   — dense GP regression (``src/models/exact/bivariate_structure.py``)
- ``svgp``      — m free 2-D inducing points, Hadamard Kuu
                  (``gridded_kronecker_structure.py:222-264``)
- ``vffgp``     — variational Fourier features, kron(diag+rank-1) Kuu
                  (``kronecker_structure.py:307-520``)
- ``asvgp``     — B1-spline RKHS features (``kronecker_structure.py:522-660``);
                  NOTE: built with the mathematically correct RKHS Gram
                  (stiffness·ℓ + mass/ℓ), not the reference's swapped-ℓ form
                  (``univariate_structure.py:654-658``) — the swap is a
                  documented reference bug (its +76 NLPD Envisat outlier).
- ``griddedgp`` — B0 cell-integral features, Toeplitz Kuu
                  (``gridded_kronecker_structure.py:1255-1433``)

The collapsed bound is evaluated in the stable factored O(n·m²) form, which
equals the reference's dense ``MultivariateNormal(Qff + σ²I).log_prob``
expression to f64 roundoff (property pinned by tests/test_models.py dense-
oracle tests).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

DTYPE = torch.float64
FLOORS = {"noise": 1e-6, "variance": 1e-8, "lengthscale": 1e-8}


# --------------------------------------------------------------------------- #
# covariance building blocks (torch f64, Matérn-1/2)
# --------------------------------------------------------------------------- #

def gram_1d(x1: torch.Tensor, x2: torch.Tensor, var, ls) -> torch.Tensor:
    return var * torch.exp(-torch.abs(x1[:, None] - x2[None, :]) / ls)


def cell_point(mesh: torch.Tensor, x: torch.Tensor, var, ls) -> torch.Tensor:
    """∫_cell_i k(|t − x_j|) dt — 3-case closed form (f64: naive forms fine)."""
    a = mesh[:-1][:, None]
    b = mesh[1:][:, None]
    xt = x[None, :]
    inside = (xt >= a) & (xt <= b)
    u = torch.abs(xt - a) / ls
    w = torch.abs(xt - b) / ls
    inside_val = 2.0 - torch.exp(-u) - torch.exp(-w)
    near = torch.minimum(u, w)
    far = torch.maximum(u, w)
    outside_val = torch.exp(-near) - torch.exp(-far)
    return var * ls * torch.where(inside, inside_val, outside_val)


def cell_cell(mesh_a: torch.Tensor, mesh_b: torch.Tensor, var, ls) -> torch.Tensor:
    """∬ k over cell pairs via P(u) = ℓ²(e^{−|u|/ℓ} + |u|/ℓ)."""
    a1, b1 = mesh_a[:-1][:, None], mesh_a[1:][:, None]
    a2, b2 = mesh_b[:-1][None, :], mesh_b[1:][None, :]

    def P(u):
        au = torch.abs(u)
        return ls * ls * (torch.exp(-au / ls) + au / ls)

    return var * (P(a1 - b2) + P(b1 - a2) - P(a1 - a2) - P(b1 - b2))


def vff_kuu_1d(n_freq: int, lims: Tuple[float, float], var, ls) -> torch.Tensor:
    a, b = lims
    om = 2.0 * math.pi * torch.arange(n_freq + 1, dtype=DTYPE) / (b - a)
    lam = 1.0 / ls
    s = 2.0 * var * lam / (lam**2 + om**2)
    s_inv = 1.0 / s
    half = (b - a) / 2.0
    alpha = half * torch.cat([2.0 * s_inv[:1], s_inv[1:], s_inv[1:]])
    beta = torch.cat([torch.ones_like(om) / torch.sqrt(var), torch.zeros(n_freq, dtype=DTYPE)])
    return torch.diag(alpha) + torch.outer(beta, beta)


def vff_kuf_1d(n_freq: int, lims: Tuple[float, float], x: torch.Tensor, ls) -> torch.Tensor:
    a, b = lims
    om = 2.0 * math.pi * torch.arange(n_freq + 1, dtype=DTYPE) / (b - a)
    inside = (x >= a) & (x < b)
    xr = x - a
    cos_in = torch.cos(om[:, None] * xr[None, :])
    sin_in = torch.sin(om[1:, None] * xr[None, :])
    r = torch.minimum(torch.abs(x - a), torch.abs(x - b))
    e = torch.exp(-r / ls)
    cos_out = e[None, :].expand_as(cos_in)
    sin_out = torch.zeros_like(sin_in)
    cos_b = torch.where(inside[None, :], cos_in, cos_out)
    sin_b = torch.where(inside[None, :], sin_in, sin_out)
    return torch.cat([cos_b, sin_b], dim=0)


def vff_kvu_1d(n_freq: int, lims: Tuple[float, float], mesh: torch.Tensor) -> torch.Tensor:
    a, b = lims
    om = 2.0 * math.pi * torch.arange(n_freq + 1, dtype=DTYPE) / (b - a)
    al = mesh[:-1][:, None] - a
    be = mesh[1:][:, None] - a
    col0 = (mesh[1:] - mesh[:-1])[:, None]
    w = om[1:][None, :]
    cos_int = (torch.sin(w * be) - torch.sin(w * al)) / w
    sin_int = -(torch.cos(w * be) - torch.cos(w * al)) / w
    return torch.cat([col0, cos_int, sin_int], dim=1)


def b1_kuf_1d(mesh: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Hat evaluations, half-hats at the ends."""
    m = mesh.shape[0]
    tl = torch.cat([mesh[:1], mesh[:-2], mesh[-2:-1]])
    tc = torch.cat([mesh[:1], mesh[1:-1], mesh[-1:]])
    tr = torch.cat([mesh[1:2], mesh[2:], mesh[-1:]])
    xt = x[None, :]
    has_up = (tc > tl)[:, None]
    has_down = (tr > tc)[:, None]
    up = (xt - tl[:, None]) / torch.where(has_up, (tc - tl)[:, None], torch.ones(m, 1, dtype=DTYPE))
    down = (tr[:, None] - xt) / torch.where(has_down, (tr - tc)[:, None], torch.ones(m, 1, dtype=DTYPE))
    in_up = has_up & (xt >= tl[:, None]) & (xt <= tc[:, None])
    in_down = has_down & (xt > tc[:, None]) & (xt <= tr[:, None])
    in_down_l = has_down & (~has_up) & (xt == tc[:, None])
    return torch.where(in_up, up, torch.zeros((), dtype=DTYPE)) + torch.where(
        in_down | in_down_l, down, torch.zeros((), dtype=DTYPE))


def b1_kuu_1d(mesh: torch.Tensor, var, ls) -> torch.Tensor:
    """Matérn-1/2 RKHS Gram of the hats (correct ℓ orientation)."""
    m = mesh.shape[0]
    d = float(mesh[1] - mesh[0])
    A = torch.zeros((m, m), dtype=DTYPE)
    B = torch.zeros((m, m), dtype=DTYPE)
    idx = torch.arange(m)
    A[idx, idx] = 2.0 * d / 3.0
    A[idx[:-1], idx[1:]] = d / 6.0
    A[idx[1:], idx[:-1]] = d / 6.0
    A[0, 0] += -d / 3.0
    A[-1, -1] += -d / 3.0
    B[idx, idx] = 2.0 / d
    B[idx[:-1], idx[1:]] = -1.0 / d
    B[idx[1:], idx[:-1]] = -1.0 / d
    B[0, 0] += -1.0 / d
    B[-1, -1] += -1.0 / d
    BC = torch.zeros((m, m), dtype=DTYPE)
    BC[0, 0] = 1.0
    BC[-1, -1] = 1.0
    return (ls * B + A / ls + BC) / (2.0 * var)


def b1_kvu_1d(mesh_knots: torch.Tensor, mesh_cells: torch.Tensor) -> torch.Tensor:
    """Exact hat integrals over grid cells (ramp integrals)."""
    tl = torch.cat([mesh_knots[:1], mesh_knots[:-2], mesh_knots[-2:-1]])
    tc = torch.cat([mesh_knots[:1], mesh_knots[1:-1], mesh_knots[-1:]])
    tr = torch.cat([mesh_knots[1:2], mesh_knots[2:], mesh_knots[-1:]])
    a = mesh_cells[:-1][:, None]
    b = mesh_cells[1:][:, None]

    def up_int(lo, hi, t0, t1):
        den = torch.where(t1 > t0, t1 - t0, torch.ones_like(t1))
        lo_c = torch.clamp(lo, t0, t1)
        hi_c = torch.clamp(hi, t0, t1)
        val = ((hi_c - t0) ** 2 - (lo_c - t0) ** 2) / (2.0 * den)
        return torch.where(t1 > t0, val, torch.zeros_like(val))

    def down_int(lo, hi, t0, t1):
        den = torch.where(t1 > t0, t1 - t0, torch.ones_like(t1))
        lo_c = torch.clamp(lo, t0, t1)
        hi_c = torch.clamp(hi, t0, t1)
        val = ((t1 - lo_c) ** 2 - (t1 - hi_c) ** 2) / (2.0 * den)
        return torch.where(t1 > t0, val, torch.zeros_like(val))

    return up_int(a, b, tl[None, :], tc[None, :]) + down_int(a, b, tc[None, :], tr[None, :])


def khatri_rao_rows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-wise Kronecker: (ma, n), (mb, n) → (ma·mb, n)."""
    return (a[:, None, :] * b[None, :, :]).reshape(a.shape[0] * b.shape[0], -1)


# --------------------------------------------------------------------------- #
# model matrix builders: name → (Kuu, Kuf(X), Kvu(grid_mesh), param spec)
# --------------------------------------------------------------------------- #

def build_matrices(name: str, p: Dict, X: torch.Tensor, grid_mesh: torch.Tensor,
                   n_splines: int, m_svgp: int = 100, n_omegas: int = 5):
    """(Kuu, Kuf) for the training inputs plus Kvu against the B0 grid."""
    v1, l1, v2, l2 = p["v1"], p["l1"], p["v2"], p["l2"]
    x1, x2 = X[:, 0], X[:, 1]
    lims = (0.0, 1.0)
    cell_mesh = torch.linspace(0.0, 1.0, n_splines + 1, dtype=DTYPE)
    if name == "svgp":
        z = p["z"]
        kuu = gram_1d(z[:, 0], z[:, 0], v1, l1) * gram_1d(z[:, 1], z[:, 1], v2, l2)
        kuf = gram_1d(z[:, 0], x1, v1, l1) * gram_1d(z[:, 1], x2, v2, l2)
        kvu = khatri_rao_rows(cell_point(grid_mesh, z[:, 0], v1, l1),
                              cell_point(grid_mesh, z[:, 1], v2, l2))
        return kuu, kuf, kvu
    if name == "vffgp":
        kuu = torch.kron(vff_kuu_1d(n_omegas, lims, v1, l1),
                         vff_kuu_1d(n_omegas, lims, v2, l2))
        kuf = khatri_rao_rows(vff_kuf_1d(n_omegas, lims, x1, l1),
                              vff_kuf_1d(n_omegas, lims, x2, l2))
        kvu1 = vff_kvu_1d(n_omegas, lims, grid_mesh)
        kvu2 = vff_kvu_1d(n_omegas, lims, grid_mesh)
        kvu = torch.kron(kvu1, kvu2)
        return kuu, kuf, kvu
    if name == "asvgp":
        knots = torch.linspace(0.0, 1.0, n_splines, dtype=DTYPE)
        kuu = torch.kron(b1_kuu_1d(knots, v1, l1), b1_kuu_1d(knots, v2, l2))
        kuf = khatri_rao_rows(b1_kuf_1d(knots, x1), b1_kuf_1d(knots, x2))
        kvu = torch.kron(b1_kvu_1d(knots, grid_mesh), b1_kvu_1d(knots, grid_mesh))
        return kuu, kuf, kvu
    if name == "griddedgp":
        kuu = torch.kron(cell_cell(cell_mesh, cell_mesh, v1, l1),
                         cell_cell(cell_mesh, cell_mesh, v2, l2))
        kuf = khatri_rao_rows(cell_point(cell_mesh, x1, v1, l1),
                              cell_point(cell_mesh, x2, v2, l2))
        kvu = torch.kron(cell_cell(grid_mesh, cell_mesh, v1, l1),
                         cell_cell(grid_mesh, cell_mesh, v2, l2))
        return kuu, kuf, kvu
    raise ValueError(name)


def grid_kvv(p: Dict, grid_mesh: torch.Tensor) -> torch.Tensor:
    return torch.kron(cell_cell(grid_mesh, grid_mesh, p["v1"], p["l1"]),
                      cell_cell(grid_mesh, grid_mesh, p["v2"], p["l2"]))


# --------------------------------------------------------------------------- #
# collapsed bound + gridded posterior + training loop
# --------------------------------------------------------------------------- #

def collapsed_elbo(kuu, kuf, kff_sum, y, noise, jitter=1e-10):
    m = kuu.shape[0]
    L = torch.linalg.cholesky(kuu + jitter * torch.mean(torch.diagonal(kuu))
                              * torch.eye(m, dtype=DTYPE))
    A = torch.linalg.solve_triangular(L, kuf, upper=False) / torch.sqrt(noise)  # (m, n)
    B = torch.eye(m, dtype=DTYPE) + A @ A.T
    LB = torch.linalg.cholesky(B)
    n = y.shape[0]
    c = torch.linalg.solve_triangular(LB, (A @ y)[:, None], upper=False)[:, 0] / torch.sqrt(noise)
    bound = -0.5 * n * torch.log(2.0 * torch.pi * noise)
    bound -= torch.sum(torch.log(torch.diagonal(LB)))
    bound -= 0.5 * torch.sum(y * y) / noise
    bound += 0.5 * torch.sum(c * c)
    bound -= torch.clamp(kff_sum - noise * torch.sum(A * A), min=0.0) / (2.0 * noise)
    return bound


def q_v(kuu, kuf, kvu, kvv, y, noise, jitter=1e-10):
    """mean = KvuΣ⁻¹Kufy/σ², var = diag(Kvv − KvuKuu⁻¹Kvuᵀ + KvuΣ⁻¹Kvuᵀ)
    (reference ``gridded_univariate_structure.py:475-488``)."""
    m = kuu.shape[0]
    eye = torch.eye(m, dtype=DTYPE)
    kuu_j = kuu + jitter * torch.mean(torch.diagonal(kuu)) * eye
    sigma_mat = kuu_j + kuf @ kuf.T / noise
    w = torch.linalg.solve(sigma_mat, kuf @ y)
    mean = kvu @ w / noise
    t1 = torch.linalg.solve(kuu_j, kvu.T)
    t2 = torch.linalg.solve(sigma_mat, kvu.T)
    var = torch.diagonal(kvv) - torch.sum(kvu * t1.T, dim=1) + torch.sum(kvu * t2.T, dim=1)
    var = torch.clamp(var, min=1e-6 * torch.diagonal(kvv))
    return mean, var


def exact_mll(X, y, p, noise):
    kff = gram_1d(X[:, 0], X[:, 0], p["v1"], p["l1"]) * gram_1d(X[:, 1], X[:, 1], p["v2"], p["l2"])
    n = y.shape[0]
    S = kff + noise * torch.eye(n, dtype=DTYPE)
    L = torch.linalg.cholesky(S)
    alpha = torch.cholesky_solve(y[:, None], L)[:, 0]
    return (-0.5 * y @ alpha - torch.sum(torch.log(torch.diagonal(L)))
            - 0.5 * n * math.log(2.0 * math.pi))


def exact_q_v(X, y, p, noise, grid_mesh):
    kff = gram_1d(X[:, 0], X[:, 0], p["v1"], p["l1"]) * gram_1d(X[:, 1], X[:, 1], p["v2"], p["l2"])
    n = y.shape[0]
    S = kff + noise * torch.eye(n, dtype=DTYPE)
    kvf = khatri_rao_rows(cell_point(grid_mesh, X[:, 0], p["v1"], p["l1"]),
                          cell_point(grid_mesh, X[:, 1], p["v2"], p["l2"]))
    kvv = grid_kvv(p, grid_mesh)
    sol = torch.linalg.solve(S, kvf.T)
    mean = kvf @ torch.linalg.solve(S, y)
    var = torch.diagonal(kvv) - torch.sum(kvf * sol.T, dim=1)
    return mean, torch.clamp(var, min=1e-6 * torch.diagonal(kvv))


def softplus(x):
    return torch.nn.functional.softplus(x)


def inv_softplus(y: float) -> float:
    return float(np.log(np.expm1(max(y, 1e-10))))


def fit(name: str, X: np.ndarray, y: np.ndarray, grid_mesh_np: np.ndarray,
        n_splines: int, n_iters: int = 1000, lr: float = 0.01,
        m_svgp: int = 100, n_omegas: int = 5, seed: int = 0):
    """Train the named reference-style model; return (metrics inputs, history).

    Same protocol as nb61 cells 28/35/42: torch Adam on all parameters
    (including Z for the SVGP), softplus positivity, non-informative init
    (variance ← var(y), noise ← var(y)/4, ℓ ← std(x)).
    """
    Xt = torch.tensor(np.asarray(X), dtype=DTYPE)
    yt = torch.tensor(np.asarray(y).reshape(-1), dtype=DTYPE)
    grid_mesh = torch.tensor(np.asarray(grid_mesh_np), dtype=DTYPE)
    yvar = float(torch.var(yt))
    raw = {
        "v1": inv_softplus(yvar), "v2": inv_softplus(yvar),
        "l1": inv_softplus(float(torch.std(Xt[:, 0]))),
        "l2": inv_softplus(float(torch.std(Xt[:, 1]))),
        "noise": inv_softplus(yvar / 4.0),
    }
    params = {k: torch.tensor(v, dtype=DTYPE, requires_grad=True) for k, v in raw.items()}
    leaves = list(params.values())
    if name == "svgp":
        z = torch.tensor(np.random.default_rng(seed).random((m_svgp, 2)), dtype=DTYPE,
                         requires_grad=True)
        leaves.append(z)

    def constrained():
        p = {k: FLOORS.get({"v1": "variance", "v2": "variance",
                            "l1": "lengthscale", "l2": "lengthscale",
                            "noise": "noise"}[k], 0.0) + softplus(v)
             for k, v in params.items()}
        if name == "svgp":
            p["z"] = z
        return p

    opt = torch.optim.Adam(leaves, lr=lr)
    losses = []
    n = yt.shape[0]
    for _ in range(n_iters):
        opt.zero_grad()
        p = constrained()
        if name == "exactgp":
            loss = -exact_mll(Xt, yt, p, p["noise"])
        else:
            kuu, kuf, _ = build_matrices(name, p, Xt, grid_mesh, n_splines,
                                         m_svgp, n_omegas)
            kff_sum = n * p["v1"] * p["v2"]
            loss = -collapsed_elbo(kuu, kuf, kff_sum, yt, p["noise"])
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))

    with torch.no_grad():
        p = {k: v.detach() for k, v in constrained().items()}
        if name == "exactgp":
            mean, var = exact_q_v(Xt, yt, p, p["noise"], grid_mesh)
        else:
            kuu, kuf, kvu = build_matrices(name, p, Xt, grid_mesh, n_splines,
                                           m_svgp, n_omegas)
            kvv = grid_kvv(p, grid_mesh)
            mean, var = q_v(kuu, kuf, kvu, kvv, yt, p["noise"])
    hyps = {k: float(v) for k, v in p.items() if k != "z"}
    return (mean.numpy(), var.numpy()), losses, hyps
