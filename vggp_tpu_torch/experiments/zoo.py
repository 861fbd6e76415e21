"""Model-zoo constructors shared by the experiment scripts.

One SGPR spec per reference model family (SVGP / VFF / ASVGP / GriddedGP are
feature choices here — SURVEY.md §7), 1D or 2D, plus the exact GP. The
port's copy of ``vggp_tpu/experiments/zoo.py``: the same specs, built from
the port's features and models.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from vggp_tpu_torch.features import (
    B1SplineFeature,
    CellIntegralFeature,
    FourierFeature,
    PointFeature,
    SplineRKHSFeature,
)
from vggp_tpu_torch.models import exact, sgpr

KIND = "matern12"


def exact_spec(ndim: int) -> exact.ExactGPSpec:
    return exact.ExactGPSpec(kinds=(KIND,) * ndim)


def sgpr_specs_1d(
    lims: Tuple[float, float] = (0.0, 1.0),
    n_inducing: int = 10,
    n_frequencies: int = 10,
    n_knots: int = 15,
    n_cells: int = 10,
) -> Dict[str, sgpr.SGPRSpec]:
    """The nb1 model zoo: SVGP(10 Z), VFF(10 freq), ASVGP(15 knots),
    GriddedGP(10 cells)."""
    a, b = lims
    pad = 0.05 * (b - a)
    return {
        "svgp": sgpr.SGPRSpec(
            kinds=(KIND,),
            features=(PointFeature(n_inducing, np.linspace(a + pad, b - pad, n_inducing)),),
        ),
        "vffgp": sgpr.SGPRSpec(
            kinds=(KIND,), features=(FourierFeature(n_frequencies, a, b),)
        ),
        "asvgp": sgpr.SGPRSpec(
            kinds=(KIND,), features=(B1SplineFeature(np.linspace(a, b, n_knots)),)
        ),
        "griddedgp": sgpr.SGPRSpec(
            kinds=(KIND,), features=(CellIntegralFeature.from_lims(n_cells, a, b),)
        ),
    }


def sgpr_specs_1d_orders(
    kind: str,
    lims: Tuple[float, float] = (0.0, 1.0),
    n_inducing: int = 10,
    n_frequencies: int = 10,
    n_knots: int = 15,
    n_cells: int = 10,
) -> Dict[str, sgpr.SGPRSpec]:
    """The full kernel×feature matrix at a given Matérn order.

    The ASVGP spline degree tracks the order (B1 hats for 1/2, quadratic B2
    for 3/2, cubic B3 for 5/2 — the ASVGP order prescription) and VFF uses
    the order's diag+rank-r Kuu, both beyond the reference's Matérn-1/2-only
    versions. The VFF domain is padded so grid cells stay inside it (its
    closed-form Kvu requires that).
    """
    a, b = lims
    pad = 0.05 * (b - a)
    vpad = 0.25 * (b - a)
    if kind == "matern12":
        asvgp = B1SplineFeature(np.linspace(a, b, n_knots))
    elif kind == "matern32":
        asvgp = SplineRKHSFeature(2, n_knots - 2, a, b)
    elif kind == "matern52":
        asvgp = SplineRKHSFeature(3, n_knots - 3, a, b)
    else:
        raise ValueError(f"no spline RKHS pairing for {kind}")
    return {
        "svgp": sgpr.SGPRSpec(
            kinds=(kind,),
            features=(PointFeature(n_inducing, np.linspace(a + pad, b - pad, n_inducing)),),
        ),
        "vffgp": sgpr.SGPRSpec(
            kinds=(kind,), features=(FourierFeature(n_frequencies, a - vpad, b + vpad),)
        ),
        "asvgp": sgpr.SGPRSpec(kinds=(kind,), features=(asvgp,)),
        "griddedgp": sgpr.SGPRSpec(
            kinds=(kind,), features=(CellIntegralFeature.from_lims(n_cells, a, b),)
        ),
    }


def sgpr_specs_2d(
    lims1: Tuple[float, float] = (0.0, 1.0),
    lims2: Tuple[float, float] = (0.0, 1.0),
    n_inducing: int = 10,
    n_frequencies: int = 15,
    n_knots: int = 15,
    n_cells: int = 15,
) -> Dict[str, sgpr.SGPRSpec]:
    """The nb3 Kronecker model zoo (per-axis features)."""
    (a1, b1), (a2, b2) = lims1, lims2

    def points(a, b):
        pad = 0.05 * (b - a)
        return PointFeature(n_inducing, np.linspace(a + pad, b - pad, n_inducing))

    return {
        "svgp": sgpr.SGPRSpec(
            kinds=(KIND, KIND), features=(points(a1, b1), points(a2, b2))
        ),
        "vffgp": sgpr.SGPRSpec(
            kinds=(KIND, KIND),
            features=(FourierFeature(n_frequencies, a1, b1),
                      FourierFeature(n_frequencies, a2, b2)),
        ),
        "asvgp": sgpr.SGPRSpec(
            kinds=(KIND, KIND),
            features=(B1SplineFeature(np.linspace(a1, b1, n_knots)),
                      B1SplineFeature(np.linspace(a2, b2, n_knots))),
        ),
        "griddedgp": sgpr.SGPRSpec(
            kinds=(KIND, KIND),
            features=(CellIntegralFeature.from_lims(n_cells, a1, b1),
                      CellIntegralFeature.from_lims(n_cells, a2, b2)),
        ),
    }
