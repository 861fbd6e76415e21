"""Standalone basis-function API of the port (``vggp_tpu/basis.py``):
callable bases ``basis(x, device=None) -> (m, n)`` over the port's
features. A tensor ``x`` stays on its own device; any other input goes to
``device``, ``cuda`` unless given (``config.resolve_device``)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from vggp_tpu_torch import config
from vggp_tpu_torch.features import B1SplineFeature, CellIntegralFeature, FourierFeature


def _as_x(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor) and device is None:
        return x.reshape(-1)
    return torch.as_tensor(x, device=config.resolve_device(device)).reshape(-1)


def _unit_params(x: torch.Tensor, lengthscale: float = 1.0) -> dict:
    return {"variance": torch.tensor(1.0, dtype=x.dtype, device=x.device),
            "lengthscale": torch.tensor(lengthscale, dtype=x.dtype, device=x.device)}


@dataclass(frozen=True)
class B0SplineBasis:
    """Piecewise-constant (indicator) basis on a uniform mesh of m cells."""

    a: float
    b: float
    m: int

    def __call__(self, x, device=None) -> torch.Tensor:
        return CellIntegralFeature.from_lims(self.m, self.a, self.b).basis_eval(_as_x(x, device))

    @property
    def mesh(self) -> np.ndarray:
        return np.linspace(self.a, self.b, self.m + 1)


@dataclass(frozen=True)
class B1SplineBasis:
    """Hat-function basis with half-hats at the boundary (m knots)."""

    a: float
    b: float
    m: int

    def __call__(self, x, device=None) -> torch.Tensor:
        x = _as_x(x, device)
        return B1SplineFeature(self.mesh).Kuf("matern12", _unit_params(x), x)

    @property
    def mesh(self) -> np.ndarray:
        return np.linspace(self.a, self.b, self.m)


@dataclass(frozen=True)
class FourierBasis:
    """VFF Fourier basis [1, cos_1 …, sin_1 …] with the Matérn continuation
    outside [a, b]."""

    n_frequencies: int
    a: float
    b: float
    kind: str = "matern12"   # matern12 | matern32 | matern52 continuation
    lengthscale: float = 1.0

    def __call__(self, x, device=None) -> torch.Tensor:
        x = _as_x(x, device)
        return FourierFeature(self.n_frequencies, self.a, self.b).Kuf(
            self.kind, _unit_params(x, self.lengthscale), x)

    @property
    def m(self) -> int:
        return 2 * self.n_frequencies + 1


def FourierBasisMatern12(n_frequencies, a, b, lengthscale=1.0):
    return FourierBasis(n_frequencies, a, b, "matern12", lengthscale)


def FourierBasisMatern32(n_frequencies, a, b, lengthscale=1.0):
    return FourierBasis(n_frequencies, a, b, "matern32", lengthscale)


def FourierBasisMatern52(n_frequencies, a, b, lengthscale=1.0):
    return FourierBasis(n_frequencies, a, b, "matern52", lengthscale)
