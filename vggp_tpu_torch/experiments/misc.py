"""Experiment bookkeeping helpers.

Equivalents of the reference's missing ``src.utils.misc`` module, with
behavior recovered from nb61 call sites (SURVEY.md §1): per-iteration
training-history dicts (cells 27-30), per-setting cross-validation dicts
(cells 32, 39), and the 6-metric evaluation row ``[mse, mae, rmse, r2,
nlpd, msll]`` (cell 65). The port's copy of ``vggp_tpu/experiments/misc.py``:
each helper also takes tensors on any device and moves each one to the host
once.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from vggp_tpu_torch import train
from vggp_tpu_torch.models.common import Gaussian
from vggp_tpu_torch.utils import metrics as M


def host(v) -> np.ndarray:
    """A numpy copy of a tensor (one device-to-host copy) or an array-like."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def generator(seed: int) -> torch.Generator:
    """A CPU generator seeded with ``seed``, where the JAX run takes
    ``PRNGKey(seed)``: the samplers make their draws on the generator's
    device and cast them, so a card run and a CPU run draw the same."""
    return torch.Generator(device="cpu").manual_seed(seed)


def dist(v) -> Dict:
    """{mean, std, q05, q95} of a sample (the sampled functionals' summary)."""
    return {"mean": float(np.mean(v)), "std": float(np.std(v)),
            "q05": float(np.quantile(v, 0.05)), "q95": float(np.quantile(v, 0.95))}


def make_training_history_dict(n_iter: int) -> Dict:
    """Pre-sized history record for an ``n_iter`` fit (nb61 cell 27)."""
    return {
        "n_iter": n_iter,
        "learning_rate": None,
        "elbo": [],
        "loss": [],
        "noise": [],
        "scale_sigma_1": [],
        "scale_sigma_2": [],
        "lengthscale_1": [],
        "lengthscale_2": [],
    }


def record_history(history: Dict, fit_history: Dict) -> Dict:
    """Fill a training-history dict from a :func:`vggp_tpu_torch.train.fit`
    result (a tensor per key, on any device)."""
    for k in history:
        if k in ("n_iter", "learning_rate"):
            continue
        if k in fit_history:
            history[k] = list(host(fit_history[k]).astype(float))
    return history


def cross_validation_dict(n_settings: int) -> Dict:
    """Per-setting CV record (nb61 cells 32/39)."""
    return {
        "setting": [None] * n_settings,
        "train_metrics": [None] * n_settings,
        "val_metrics": [None] * n_settings,
        "train_elbo": [None] * n_settings,
        "val_elbo": [None] * n_settings,
    }


def evaluation_metric_row(
    true_grid,
    grid_pred: Gaussian,
    train_y: Optional[np.ndarray] = None,
) -> List[float]:
    """``[mse, mae, rmse, r2, nlpd, msll]`` of a gridded prediction vs truth
    (nb61 cell 65 row layout).

    ``true_grid`` is the (g1, g2) or flat ground-truth integral grid;
    ``grid_pred`` a q(v) Gaussian. MSLL's trivial-model baseline uses
    ``train_y`` when given, else the truth grid itself.
    """
    truth = np.asarray(host(true_grid), dtype=np.float64).reshape(-1)
    mean = host(grid_pred.mean)
    var = host(grid_pred.variance())
    ty = truth if train_y is None else host(train_y)
    return M.evaluation_metric_row(truth, mean, var, ty)


def calibration_row(true_grid, grid_pred: Gaussian) -> dict:
    """Calibration/proper-scoring summary of a gridded prediction vs truth:
    ``{crps, coverage50, coverage90, coverage95}`` (beyond-reference —
    complements the nb61 accuracy row with whether the predictive variances
    are honest, which rmse/r² cannot see)."""
    truth = np.asarray(host(true_grid), dtype=np.float64).reshape(-1)
    mean = host(grid_pred.mean)
    var = host(grid_pred.variance())
    return {
        "crps": M.crps_gaussian(truth, mean, var),
        "coverage50": M.interval_coverage(truth, mean, var, 0.50),
        "coverage90": M.interval_coverage(truth, mean, var, 0.90),
        "coverage95": M.interval_coverage(truth, mean, var, 0.95),
    }


def check_tensors_equal(*arrays, atol: float = 0.0) -> bool:
    """Assert all arrays are elementwise equal (nb4 cell 24 mesh-consistency
    check). Returns True; raises AssertionError with the first offender."""
    ref = host(arrays[0])
    for i, a in enumerate(arrays[1:], start=1):
        a = host(a)
        if a.shape != ref.shape or not np.allclose(ref, a, atol=atol, rtol=0.0):
            raise AssertionError(f"array {i} differs from array 0")
    return True


def timed_fit(loss_fn, params: Dict, n_iters: int, learning_rate: float, trainable=None):
    """:func:`vggp_tpu_torch.train.fit` on the wall clock: (final params,
    history, final loss, seconds). The clock stops after the final loss is
    read to the host, so an asynchronous launch queue cannot end it early."""
    t0 = time.time()
    p_fit, hist = train.fit(loss_fn, params, n_iters, learning_rate, trainable=trainable)
    final_loss = float(hist["loss"][-1])
    return p_fit, hist, final_loss, time.time() - t0


def timed_fit_minibatch(loss_fn, params: Dict, X, y, n_iters: int, batch_size: int,
                        learning_rate: float, seed: int):
    """:func:`vggp_tpu_torch.train.fit_minibatch` on the wall clock, as
    :func:`timed_fit`: (final params, history, final loss, seconds). The
    batches come from a CPU generator, so a card run and a CPU run see the
    same ones."""
    t0 = time.time()
    p_fit, hist = train.fit_minibatch(loss_fn, params, X, y, n_iters=n_iters,
                                      batch_size=batch_size, learning_rate=learning_rate,
                                      seed=seed, generator_device="cpu")
    final_loss = float(hist["loss"][-1])
    return p_fit, hist, final_loss, time.time() - t0
