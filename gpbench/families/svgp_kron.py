"""The whitened Kronecker SVGP of ``vggp_tpu_torch.models.svgp``: how the
benchmark builds it from a configuration, what a step and a request call,
and the products each needs.

Parameters travel as the benchmark's own dict of constrained values
(``variance`` and ``lengthscale`` per axis, ``noise``, ``mu``, the factors
``L``), made here from the configuration and the seed and handed alike to
the program and to the reference.
"""

from __future__ import annotations

import torch

from gpbench import costs, data
from gpbench.compare import named_leaves
from gpbench.reference import svgp_kron as reference


def init_params(cfg: dict, device) -> dict:
    """The configuration's initial parameters: σ², ℓ, noise, μ = 0, L_i = I."""
    init = cfg["init"]
    ms = cfg["cells"]
    return {"variance": [data.scalar(init["variance"], device) for _ in ms],
            "lengthscale": [data.scalar(init["lengthscale"], device) for _ in ms],
            "noise": data.scalar(init["noise"], device),
            "mu": torch.zeros(ms, dtype=torch.float32, device=device),
            "L": [torch.eye(m, dtype=torch.float32, device=device) for m in ms]}


def served_params(cfg: dict, device, seed: int) -> dict:
    """A fitted model to serve: σ², ℓ and noise as the configuration states,
    μ standard normal times ``mu_std``, each L_i lower-triangular with a
    diagonal uniform in ``L_diag`` and entries below it normal with
    ``L_offdiag_std``, all drawn from the seed."""
    s = cfg["serve"]
    ms = cfg["cells"]
    g = data.generator(device, seed, "params")
    mu = s["mu_std"] * torch.randn(ms, generator=g, device=device, dtype=torch.float32)
    Ls = []
    lo, hi = s["L_diag"]
    for m in ms:
        off = s["L_offdiag_std"] * torch.randn((m, m), generator=g, device=device,
                                               dtype=torch.float32)
        diag = lo + (hi - lo) * torch.rand((m,), generator=g, device=device, dtype=torch.float32)
        Ls.append(torch.tril(off, -1) + torch.diag(diag))
    return {"variance": [data.scalar(v, device) for v in s["variance"]],
            "lengthscale": [data.scalar(v, device) for v in s["lengthscale"]],
            "noise": data.scalar(s["noise"], device), "mu": mu, "L": Ls}


def _spec(cfg: dict):
    from vggp_tpu_torch import CellIntegralFeature, SVGPSpec

    feats = tuple(CellIntegralFeature.from_lims(m, lo, hi)
                  for m, (lo, hi) in zip(cfg["cells"], cfg["domain"]))
    return SVGPSpec(kinds=tuple(cfg["kinds"]), features=feats, num_data=cfg["num_data"],
                    variational="kron", jitter=cfg["rel_jitter"])


def _program_params(p: dict) -> dict:
    from vggp_tpu_torch.models.svgp import raw_from_chol

    axes = tuple({"variance": v, "lengthscale": l}
                 for v, l in zip(p["variance"], p["lengthscale"]))
    q = {"mu": p["mu"]}
    for i, L in enumerate(p["L"]):
        q[f"raw_L{i + 1}"] = raw_from_chol(L)
    return {"axes": axes, "noise": p["noise"], "q": q}


def program_fit(cfg: dict, p: dict) -> tuple:
    """(step, the raw leaves by name, the optimizer): ``train.make_step_fn``
    over ``svgp.loss``, Adam as the configuration states. ``step(xb, yb)``."""
    from vggp_tpu_torch import train
    from vggp_tpu_torch.models import svgp

    spec = _spec(cfg)
    model = svgp.SVGP(spec, params=_program_params(p), device=p["noise"].device)
    o = cfg["optimizer"]
    opt = torch.optim.Adam(model.parameters(), lr=o["lr"], betas=tuple(o["betas"]),
                           eps=o["eps"])
    raw = model.raw_params()
    step = train.make_step_fn(lambda q, xb, yb: svgp.loss(spec, q, xb, yb), raw, opt)
    return step, named_leaves(raw), opt


def program_serve(cfg: dict, p: dict):
    """request(xs) → (mean, var): ``svgp.posterior_from_state`` on one
    ``precompute`` state, made here."""
    from vggp_tpu_torch.models import svgp

    spec = _spec(cfg)
    params = _program_params(p)
    with torch.no_grad():
        state = svgp.precompute(spec, params)

    def request(xs):
        with torch.no_grad():
            g = svgp.posterior_from_state(spec, params, state, xs)
        return g.mean, g.var

    return request


def fit_fmas(cfg: dict, batch: int) -> dict:
    return costs.svgp_kron_fit_fmas(cfg["cells"], batch)


def serve_fmas(cfg: dict, n: int) -> dict:
    return costs.svgp_kron_serve_fmas(cfg["cells"], n)
