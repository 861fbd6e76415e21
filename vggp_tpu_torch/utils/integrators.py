"""Numerical integrators for gridded ground truth: the port's copy of
``vggp_tpu/utils/integrators.py``, numpy and scipy only.

- :func:`integrate_1d` — per-mesh-interval adaptive quadrature (reference
  ``src/utils/integrators.py:10-30``): the analytic-truth oracle for
  validating q(v) cell-integral means.
- :func:`simpson_grid_2d` / :func:`trapz_grid_2d` / :func:`average_grid_2d` —
  grid a dense 2D field into n×n cell integrals/means (reference
  ``src/utils/dataloaders.py:461-539``, GulfStream ground-truth gridding).
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np


def integrate_1d(function: Callable, mesh: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """scipy ``quad`` of ``function`` over each [mesh[i-1], mesh[i]] interval."""
    from scipy import integrate as _integrate

    areas, errors = [], []
    mesh = np.asarray(mesh)
    for i in range(1, len(mesh)):
        result, error = _integrate.quad(function, mesh[i - 1], mesh[i])
        areas.append(result)
        errors.append(error)
    return np.array(areas), np.array(errors)


def _cell_slices(npts: int, n_grids: int):
    """Shared-edge cell slices: cell i covers samples
    [round(i·(N−1)/n), round((i+1)·(N−1)/n)] inclusive.

    Adjacent cells share their boundary sample, so the cells tile the domain
    exactly. (The reference integrates *disjoint* k-point blocks,
    ``dataloaders.py:513-539``, which drops the strip between blocks and
    biases every cell integral low by ~1/k — a bug not replicated; its
    20×20 gridding of 600-point fields loses 2/30 of each cell.)
    """
    if npts - 1 < n_grids:
        raise ValueError(
            f"{npts} samples cannot form {n_grids} cells (need at least "
            f"{n_grids + 1}; one-sample cells would integrate to zero)"
        )
    edges = np.rint(np.arange(n_grids + 1) * (npts - 1) / n_grids).astype(int)
    return [slice(edges[i], edges[i + 1] + 1) for i in range(n_grids)]


def average_grid_2d(field: np.ndarray, n_grids: int) -> np.ndarray:
    """Per-cell mean of a dense square field → (n_grids, n_grids)."""
    if field.shape[0] != field.shape[1]:
        raise ValueError("field must be square")
    sls = _cell_slices(field.shape[0], n_grids)
    out = np.empty((n_grids, n_grids))
    for i, si in enumerate(sls):
        for j, sj in enumerate(sls):
            out[i, j] = field[si, sj].mean()
    return out


def _grid_2d(field, xs, ys, n_grids, rule):
    if field.shape != (len(xs), len(ys)):
        raise ValueError(
            f"field shape {field.shape} must be (len(xs), len(ys)) = ({len(xs)}, {len(ys)})"
        )
    sx = _cell_slices(len(xs), n_grids)
    sy = _cell_slices(len(ys), n_grids)
    out = np.empty((n_grids, n_grids))
    for i, si in enumerate(sx):
        for j, sj in enumerate(sy):
            cell = field[si, sj]
            # inner: integrate along axis 1 (the ys axis), outer along xs
            out[i, j] = rule(rule(cell, ys[sj], axis=1), xs[si], axis=0)
    return out


def trapz_grid_2d(field: np.ndarray, xs: np.ndarray, ys: np.ndarray, n_grids: int) -> np.ndarray:
    """Per-cell trapezoid double integral of a dense field.

    ``field[i, j]`` is indexed (xs[i], ys[j]); cells share edge samples and
    each axis uses its own coordinate spacing.
    """
    return _grid_2d(field, np.asarray(xs), np.asarray(ys), n_grids,
                    lambda v, c, axis: np.trapezoid(v, x=c, axis=axis))


def grad_trapz_grid_2d(field: np.ndarray, xs: np.ndarray, ys: np.ndarray,
                       n_grids: int, axis: int) -> np.ndarray:
    """Per-cell integrals of ∂field/∂axis — ground truth for q(∂v).

    By the fundamental theorem of calculus the axis integral collapses to a
    face difference of the field itself, trapezoid-integrated along the other
    axis: NO numerical differentiation touches the dense field (the same
    identity the model heads use, ``models.common.grad_grid_kvu``). Cells
    share edge samples exactly like :func:`trapz_grid_2d`.
    """
    field, xs, ys = np.asarray(field), np.asarray(xs), np.asarray(ys)
    if field.shape != (len(xs), len(ys)):
        raise ValueError(
            f"field shape {field.shape} must be (len(xs), len(ys)) = ({len(xs)}, {len(ys)})"
        )
    if axis not in (0, 1):
        raise ValueError("axis must be 0 or 1")
    sx = _cell_slices(len(xs), n_grids)
    sy = _cell_slices(len(ys), n_grids)
    out = np.empty((n_grids, n_grids))
    for i, si in enumerate(sx):
        for j, sj in enumerate(sy):
            if axis == 0:
                diff = field[si.stop - 1, sj] - field[si.start, sj]
                out[i, j] = np.trapezoid(diff, x=ys[sj])
            else:
                diff = field[si, sj.stop - 1] - field[si, sj.start]
                out[i, j] = np.trapezoid(diff, x=xs[si])
    return out


def simpson_grid_2d(field: np.ndarray, xs: np.ndarray, ys: np.ndarray, n_grids: int) -> np.ndarray:
    """Per-cell Simpson double integral (reference ``dataloaders.py:513-539``
    semantics, with shared-edge cells and per-axis spacings — see
    :func:`_cell_slices`)."""
    from scipy import integrate as _integrate

    return _grid_2d(field, np.asarray(xs), np.asarray(ys), n_grids,
                    lambda v, c, axis: _integrate.simpson(v, x=c, axis=axis))
