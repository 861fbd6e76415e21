"""Evaluation metrics (``vggp_tpu/utils/metrics.py``).

mse/mae/rmse/r² mirror reference ``src/utils/evaluationmetrics.py:6-54``
(including the 2-D shape contract) and take tensors on any device, as the
JAX package's take jnp arrays; nlpd and msll recover the two metrics the
reference imports from a missing module. The evaluation row and the
calibration metrics run in host numpy and accept numpy arrays or tensors.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _check(true, pred):
    if true.dim() != 2 or pred.dim() != 2:
        raise AssertionError(
            f"tensors must be 2D, got {true.dim()}D and {pred.dim()}D"
        )
    if true.shape != pred.shape:
        raise AssertionError(f"shape mismatch: {tuple(true.shape)} vs {tuple(pred.shape)}")


def mean_squared_error(true: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    _check(true, pred)
    return torch.mean((true - pred) ** 2)


def mean_absolute_error(true: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    _check(true, pred)
    return torch.mean(torch.abs(true - pred))


def root_mean_squared_error(true: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    _check(true, pred)
    return torch.sqrt(torch.mean((true - pred) ** 2))


def r_squared(true: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    _check(true, pred)
    rss = torch.sum((true - pred) ** 2)
    tss = torch.sum((true - torch.mean(true)) ** 2)
    return 1.0 - rss / tss


def negative_log_predictive_density(
    true: torch.Tensor, pred_mean: torch.Tensor, pred_var: torch.Tensor
) -> torch.Tensor:
    """NLPD = −mean log N(y* | μ*, σ*²) under the predictive marginals."""
    true = true.reshape(-1)
    mu = pred_mean.reshape(-1)
    var = pred_var.reshape(-1)
    logp = -0.5 * torch.log(2.0 * math.pi * var) - (true - mu) ** 2 / (2.0 * var)
    return -torch.mean(logp)


def mean_standardized_log_loss(
    true: torch.Tensor,
    pred_mean: torch.Tensor,
    pred_var: torch.Tensor,
    train_y: torch.Tensor,
) -> torch.Tensor:
    """MSLL: NLPD minus the NLPD of the trivial N(mean(y_train), var(y_train))."""
    true = true.reshape(-1)
    ty = train_y.reshape(-1)
    mu0, var0 = torch.mean(ty), torch.var(ty, correction=0)
    nlpd_model = negative_log_predictive_density(true, pred_mean, pred_var)
    logp0 = -0.5 * torch.log(2.0 * math.pi * var0) - (true - mu0) ** 2 / (2.0 * var0)
    return nlpd_model - (-torch.mean(logp0))


# nb61 imports the name `mean_squared_log_loss`; its printed values are
# standardized log losses — alias accordingly.
mean_squared_log_loss = mean_standardized_log_loss


def _host(v) -> np.ndarray:
    """A flat float64 host copy of a numpy array, a tensor or a sequence."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v, dtype=np.float64).reshape(-1)


def evaluation_metric_row(true, pred_mean, pred_var, train_y):
    """[mse, mae, rmse, r2, nlpd, msll] — nb61 cell 65 row layout, in host
    numpy (experiment bookkeeping loops, one host copy of each input)."""
    truth, mean, var, ty = map(_host, (true, pred_mean, pred_var, train_y))
    err = truth - mean
    mse = float(np.mean(err**2))
    mae = float(np.mean(np.abs(err)))
    rmse = float(np.sqrt(mse))
    r2 = float(1.0 - np.sum(err**2) / np.sum((truth - truth.mean()) ** 2))
    logp = -0.5 * np.log(2 * np.pi * var) - err**2 / (2 * var)
    nlpd = float(-np.mean(logp))
    mu0, var0 = ty.mean(), ty.var()
    logp0 = -0.5 * np.log(2 * np.pi * var0) - (truth - mu0) ** 2 / (2 * var0)
    msll = nlpd - float(-np.mean(logp0))
    return [mse, mae, rmse, r2, nlpd, msll]


# --------------------------------------------------------------------------- #
# Calibration / proper-scoring metrics (beyond-reference), in host numpy.
# --------------------------------------------------------------------------- #


def crps_gaussian(true, pred_mean, pred_var) -> float:
    """Mean continuous ranked probability score of Gaussian predictive
    marginals — a strictly proper scoring rule in the units of y.

    Closed form (Gneiting & Raftery 2007, eq. 21):
    CRPS(N(μ,σ²), y) = σ·[ z(2Φ(z) − 1) + 2φ(z) − 1/√π ],  z = (y − μ)/σ.
    Lower is better; for σ → 0 it reduces to |y − μ|.
    """
    from scipy.special import erf

    y, mu, sd = _host(true), _host(pred_mean), np.sqrt(_host(pred_var))
    z = (y - mu) / sd
    cdf = 0.5 * (1.0 + erf(z / np.sqrt(2.0)))
    pdf = np.exp(-0.5 * z * z) / np.sqrt(2.0 * np.pi)
    return float(np.mean(sd * (z * (2.0 * cdf - 1.0) + 2.0 * pdf - 1.0 / np.sqrt(np.pi))))


def interval_coverage(true, pred_mean, pred_var, level: float = 0.95) -> float:
    """Empirical coverage of the central ``level`` predictive interval; a
    calibrated model returns ≈ ``level``, an overconfident one less."""
    from scipy.special import ndtri

    y, mu, sd = _host(true), _host(pred_mean), np.sqrt(_host(pred_var))
    half = ndtri(0.5 + level / 2.0)  # e.g. 1.959964 at level 0.95
    return float(np.mean(np.abs(y - mu) <= half * sd))


def calibration_curve(true, pred_mean, pred_var, levels=None):
    """(nominal, empirical) central-interval coverage pairs via the PIT:
    two float64 arrays; a calibrated model tracks the diagonal."""
    if levels is None:
        levels = np.linspace(0.1, 0.9, 9)
    levels = np.asarray(levels, dtype=np.float64)
    emp = np.asarray(
        [interval_coverage(true, pred_mean, pred_var, level=l) for l in levels]
    )
    return levels, emp
