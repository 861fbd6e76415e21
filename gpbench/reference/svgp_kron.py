"""The whitened SVGP with a Kronecker variational family, Gaussian likelihood,
written out plainly.

Per axis i of cells: Kuu_i (jittered by the configuration's relative
jitter), F_i its Cholesky factor, a_i = F_i⁻¹·Kuf_i (m_i, n). With q(w) =
N(μ, S₁ ⊗ S₂), S_i = L_iLᵢᵀ, μ of shape (m₁, m₂):

    mean_n    = Σ_ab μ_ab·a₁[a, n]·a₂[b, n]
    var_red_n = ‖a₁[:, n]‖²·‖a₂[:, n]‖²
    var_add_n = ‖L₁ᵀa₁[:, n]‖²·‖L₂ᵀa₂[:, n]‖²
    var_f     = max(k_ff − var_red, 0) + var_add,  k_ff = σ₁²σ₂²
    ELBO      = (N/n)·Σ_n [−½log(2πσ²) − ((y − mean)² + var_f)/(2σ²)] − KL
    KL        = ½(‖μ‖² + ‖L₁‖²‖L₂‖² − m − 2m₂Σlog diag L₁ − 2m₁Σlog diag L₂)

The parameters are raw: the positive ones under a floored softplus, L_i
lower-triangular with a softplus diagonal, as the configuration states.
Gradients by autograd, the batch in blocks of points so that it fits.
"""

from __future__ import annotations

import math

import torch

from gpbench.reference import cells_m12
from gpbench.reference.precision import Precision

AXES = 2


def softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def inv_softplus(y):
    return y + torch.log(-torch.expm1(-y))


def chol_from_raw(raw):
    d = torch.diagonal(raw)
    return torch.tril(raw, -1) + torch.diag(softplus(d))


def raw_from_chol(chol):
    d = torch.diagonal(chol)
    return torch.tril(chol, -1) + torch.diag(torch.log(torch.expm1(d)))


def raw_from_constrained(cfg: dict, p: dict) -> dict:
    """Raw leaves from constrained values: σ², ℓ per axis, noise (each less
    its floor, through softplus⁻¹), μ, and the factors L_i."""
    fl = cfg["floors"]
    raw = {}
    for i in range(AXES):
        raw[f"axes.{i}.variance"] = inv_softplus(p["variance"][i] - fl["variance"])
        raw[f"axes.{i}.lengthscale"] = inv_softplus(p["lengthscale"][i] - fl["lengthscale"])
    raw["noise"] = inv_softplus(p["noise"] - fl["noise"])
    raw["q.mu"] = p["mu"]
    for i in range(AXES):
        raw[f"q.raw_L{i + 1}"] = raw_from_chol(p["L"][i])
    return raw


def constrain(cfg: dict, raw: dict) -> dict:
    fl = cfg["floors"]
    return {"variance": [fl["variance"] + softplus(raw[f"axes.{i}.variance"])
                         for i in range(AXES)],
            "lengthscale": [fl["lengthscale"] + softplus(raw[f"axes.{i}.lengthscale"])
                            for i in range(AXES)],
            "noise": fl["noise"] + softplus(raw["noise"]),
            "mu": raw["q.mu"],
            "L": [chol_from_raw(raw[f"q.raw_L{i + 1}"]) for i in range(AXES)]}


def meshes(cfg: dict, like: torch.Tensor) -> list:
    return [torch.linspace(lo, hi, m + 1, dtype=torch.float64).to(like)
            for m, (lo, hi) in zip(cfg["cells"], cfg["domain"])]


def whiteners(cfg: dict, p: dict, mesh: list) -> list:
    """F_i⁻¹ of the jittered Kuu_i of each axis."""
    return [cells_m12.inv_chol(cells_m12.jittered(
        cells_m12.kuu(mesh[i], p["variance"][i], p["lengthscale"][i]), cfg["rel_jitter"]))
        for i in range(AXES)]


def moments(p: dict, finv: list, mesh: list, x: torch.Tensor, prec: Precision):
    """(mean, var_f) of q(f) at the points ``x`` (n, 2)."""
    a = [prec.mm(finv[i], cells_m12.kuf(mesh[i], x[:, i], p["variance"][i],
                                       p["lengthscale"][i])) for i in range(AXES)]
    mean = torch.sum(a[0] * prec.mm(p["mu"], a[1]), dim=0)
    var_red = torch.sum(a[0] * a[0], dim=0) * torch.sum(a[1] * a[1], dim=0)
    t = [prec.mm(p["L"][i].T, a[i]) for i in range(AXES)]
    var_add = torch.sum(t[0] * t[0], dim=0) * torch.sum(t[1] * t[1], dim=0)
    kff = p["variance"][0] * p["variance"][1]
    return mean, torch.clamp(kff - var_red, min=0.0) + var_add


def kl(p: dict) -> torch.Tensor:
    ms = [L.shape[0] for L in p["L"]]
    m = math.prod(ms)
    tr = math.prod(torch.sum(L * L) for L in p["L"])
    logdet = sum(2.0 * (m // ms[i]) * torch.sum(torch.log(torch.diagonal(L)))
                 for i, L in enumerate(p["L"]))
    return 0.5 * (torch.sum(p["mu"] ** 2) + tr - m - logdet)


def loss_and_grad(cfg: dict, raw: dict, x: torch.Tensor, y: torch.Tensor,
                  prec: Precision, block: int) -> tuple:
    """(−ELBO, {leaf: gradient}) at the raw leaves ``raw`` on the batch
    (x, y), accumulated over blocks of ``block`` points."""
    leaves = {k: v.detach().to(prec.dtype).requires_grad_(True) for k, v in raw.items()}
    mesh = meshes(cfg, x.to(prec.dtype))
    n = y.shape[0]
    total = torch.zeros((), dtype=torch.float64, device=x.device)
    for s in range(0, n, block):
        xb, yb = x[s:s + block].to(prec.dtype), y[s:s + block].to(prec.dtype)
        p = constrain(cfg, leaves)
        mean, var_f = moments(p, whiteners(cfg, p, mesh), mesh, xb, prec)
        noise = p["noise"]
        ell = -0.5 * torch.log(2.0 * math.pi * noise) - ((yb - mean) ** 2 + var_f) / (2.0 * noise)
        part = -(cfg["num_data"] / n) * torch.sum(ell)
        part.backward()
        total = total + part.detach().double()
    part = kl(constrain(cfg, leaves))
    part.backward()
    total = total + part.detach().double()
    return total, {k: v.grad.detach() for k, v in leaves.items()}


@torch.no_grad()
def posterior(cfg: dict, p: dict, x: torch.Tensor, prec: Precision, block: int) -> tuple:
    """(mean, var) of q(f) at the points ``x``, constrained parameters ``p``."""
    p = {k: ([t.to(prec.dtype) for t in v] if isinstance(v, list) else v.to(prec.dtype))
         for k, v in p.items()}
    mesh = meshes(cfg, p["mu"])
    finv = whiteners(cfg, p, mesh)
    means, vars_ = [], []
    for s in range(0, x.shape[0], block):
        mean, var = moments(p, finv, mesh, x[s:s + block].to(prec.dtype), prec)
        means.append(mean)
        vars_.append(var)
    return torch.cat(means), torch.cat(vars_)
