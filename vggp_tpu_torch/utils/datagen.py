"""Synthetic data generators: the port's copy of ``vggp_tpu/utils/datagen.py``
(reference ``src/utils/datagenerators.py:8-74``), numpy only."""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np


def gen_1d(
    fun: Callable[[np.ndarray], np.ndarray],
    leftlim: float,
    rightlim: float,
    nobs: int,
    randomspacing: bool = False,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Sample ``fun`` on a 1D domain (evenly spaced or uniform random)."""
    if randomspacing:
        rng = np.random.default_rng(seed)
        domain = rng.random(nobs) * (rightlim - leftlim) + leftlim
    else:
        domain = np.linspace(leftlim, rightlim, nobs)
    return domain, fun(domain)


def gen_2d(
    func: Callable[[np.ndarray, np.ndarray], np.ndarray],
    x1lims: Tuple[float, float],
    x2lims: Tuple[float, float],
    nobs: int,
    randomspacing: bool = False,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Sample ``func`` on an nobs×nobs meshgrid → (X (n,2), y (n,))."""
    x1_min, x1_max = x1lims
    x2_min, x2_max = x2lims
    if randomspacing:
        rng = np.random.default_rng(seed)
        d1 = rng.random(nobs) * (x1_max - x1_min) + x1_min
        d2 = rng.random(nobs) * (x2_max - x2_min) + x2_min
    else:
        d1 = np.linspace(x1_min, x1_max, nobs)
        d2 = np.linspace(x2_min, x2_max, nobs)
    X1, X2 = np.meshgrid(d1, d2)
    X = np.vstack([X1.ravel(), X2.ravel()]).T
    y = func(X[:, 0], X[:, 1])
    return X, y
