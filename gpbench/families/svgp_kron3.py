"""The three-axis whitened Kronecker SVGP (lon × lat × time) of
``vggp_tpu_torch.models.svgp``: ``svgp_kron``'s build functions, which take any
number of axes, with the three-axis plain reference and the step's least
products.
"""

from __future__ import annotations

from gpbench import contract, costs
from gpbench.families.svgp_kron import init_params, program_fit  # noqa: F401
from gpbench.reference import svgp_kron3 as reference  # noqa: F401


def fit_fmas(cfg: dict, batch: int) -> dict:
    """A step's least products: each axis's own terms as
    ``costs.svgp_kron_fit_fmas`` counts them for that axis alone, and the
    contraction as ``gpbench.contract`` counts it (three products, not the
    five that ``svgp_kron_fit_fmas`` counts at three axes)."""
    out: dict = {}
    for m in cfg["cells"]:
        for prec, f in costs.svgp_kron_fit_fmas([m], batch).items():
            out[prec] = out.get(prec, 0.0) + f
    m_total = 1
    for m in cfg["cells"]:
        m_total *= m
    out["bf16x6"] = out.get("bf16x6", 0.0) + contract.fmas(m_total, batch)
    return out
