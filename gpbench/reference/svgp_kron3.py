"""The whitened SVGP with a three-axis Kronecker variational family, Gaussian
likelihood, written out plainly: ``svgp_kron``'s model with a third axis
(lon × lat × time).

Per axis i of cells: Kuu_i (jittered by the configuration's relative
jitter), F_i its Cholesky factor, a_i = F_i⁻¹·Kuf_i (m_i, n). With q(w) =
N(μ, S₁ ⊗ S₂ ⊗ S₃), S_i = L_iLᵢᵀ, μ of shape (m₁, m₂, m₃):

    mean_n    = Σ_abc μ_abc·a₁[a, n]·a₂[b, n]·a₃[c, n]
    var_red_n = ‖a₁[:, n]‖²·‖a₂[:, n]‖²·‖a₃[:, n]‖²
    var_add_n = ‖L₁ᵀa₁[:, n]‖²·‖L₂ᵀa₂[:, n]‖²·‖L₃ᵀa₃[:, n]‖²
    var_f     = max(k_ff − var_red, 0) + var_add,  k_ff = σ₁²σ₂²σ₃²
    ELBO      = (N/n)·Σ_n [−½log(2πσ²) − ((y − mean)² + var_f)/(2σ²)] − KL
    KL        = ½(‖μ‖² + Π‖L_i‖² − m − Σ_i 2(m/m_i)Σlog diag L_i)

The mean contracts μ's first axis with a₁ in one product, W = a₁ᵀμ
(n, m₂m₃), then sums W against a₂ and a₃ point by point. The parameters
are raw, as in ``svgp_kron``. Gradients by autograd, the batch in blocks of
points so that it fits; no product in TF32.
"""

from __future__ import annotations

import math

import torch

from gpbench.reference import cells_m12
from gpbench.reference.precision import Precision, exact_products
from gpbench.reference.svgp_kron import (chol_from_raw, inv_softplus, kl, meshes,
                                         raw_from_chol, softplus)

AXES = 3


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


def whiteners(cfg: dict, p: dict, mesh: list) -> list:
    """F_i⁻¹ of the jittered Kuu_i of each axis."""
    return [cells_m12.inv_chol(cells_m12.jittered(
        cells_m12.kuu(mesh[i], p["variance"][i], p["lengthscale"][i]), cfg["rel_jitter"]))
        for i in range(AXES)]


def moments(p: dict, finv: list, mesh: list, x: torch.Tensor, prec: Precision):
    """(mean, var_f) of q(f) at the points ``x`` (n, 3)."""
    a = [prec.mm(finv[i], cells_m12.kuf(mesh[i], x[:, i], p["variance"][i],
                                       p["lengthscale"][i])) for i in range(AXES)]
    m1, m2, m3 = p["mu"].shape
    w = prec.mm(a[0].T, p["mu"].reshape(m1, m2 * m3)).reshape(-1, m2, m3)
    mean = torch.sum(torch.sum(w * a[2].T[:, None, :], dim=2) * a[1].T, dim=1)
    var_red = math.prod(torch.sum(a[i] * a[i], dim=0) for i in range(AXES))
    t = [prec.mm(p["L"][i].T, a[i]) for i in range(AXES)]
    var_add = math.prod(torch.sum(t[i] * t[i], dim=0) for i in range(AXES))
    kff = math.prod(p["variance"])
    return mean, torch.clamp(kff - var_red, min=0.0) + var_add


def loss_and_grad(cfg: dict, raw: dict, x: torch.Tensor, y: torch.Tensor,
                  prec: Precision, block: int) -> tuple:
    """(−ELBO, {leaf: gradient}) at the raw leaves ``raw`` on the batch
    (x, y), accumulated over blocks of ``block`` points."""
    leaves = {k: v.detach().to(prec.dtype).requires_grad_(True) for k, v in raw.items()}
    mesh = meshes(cfg, x.to(prec.dtype))
    n = y.shape[0]
    total = torch.zeros((), dtype=torch.float64, device=x.device)
    with exact_products():
        for s in range(0, n, block):
            xb, yb = x[s:s + block].to(prec.dtype), y[s:s + block].to(prec.dtype)
            p = constrain(cfg, leaves)
            mean, var_f = moments(p, whiteners(cfg, p, mesh), mesh, xb, prec)
            noise = p["noise"]
            ell = (-0.5 * torch.log(2.0 * math.pi * noise)
                   - ((yb - mean) ** 2 + var_f) / (2.0 * noise))
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
    means, vars_ = [], []
    with exact_products():
        finv = whiteners(cfg, p, mesh)
        for s in range(0, x.shape[0], block):
            mean, var = moments(p, finv, mesh, x[s:s + block].to(prec.dtype), prec)
            means.append(mean)
            vars_.append(var)
    return torch.cat(means), torch.cat(vars_)
