"""L-BFGS with a zoom line search, as ``optax.lbfgs()`` computes it (optax
0.2.6: ``transform.scale_by_lbfgs``, ``linesearch.zoom_linesearch`` and
``scale_by_zoom_linesearch``, ``utils.value_and_grad_from_state``), on one
flat parameter vector — the optimizer of ``train.fit_lbfgs``.

The direction is the two-loop product of the last ``memory_size`` pairs
(w_{k+1} − w_k, g_{k+1} − g_k) with the initial scale γ = sᵀy / yᵀy, and
min(1, 1/‖g‖) at the first step. The step size comes from the zoom line
search of Nocedal and Wright (Algorithms 3.5 and 3.6) with optax's
defaults for ``lbfgs()``: an initial guess of 1, at most 20 evaluations,
sufficient decrease at slope 1e-4 (or the approximate condition of Hager
and Zhang at 1e-6 of |f|), curvature at 0.9 of the initial slope, a cubic
interpolant inside the central 60% of the interval, else a quadratic
inside the central 80%, else bisection; a failed search falls back to the
best step with sufficient decrease, or to no step. The value and gradient
at the accepted step are kept for the next iteration.

The vectors stay on their device. The line search's scalars are host
float64 (numpy, for IEEE inf and NaN): a search is a host loop, one
value-and-gradient and one read per evaluation.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Tuple

import numpy as np
import torch

# optax.lbfgs()'s line search: scale_by_zoom_linesearch(max_linesearch_steps=20,
# initial_guess_strategy="one") with the transform's other defaults
MAX_LINESEARCH_STEPS = 20
SLOPE_RTOL = 1e-4
CURV_RTOL = 0.9
APPROX_DEC_RTOL = 1e-6
INCREASE_FACTOR = 2.0
INTERVAL_THRESHOLD = 1e-5
TOL = 0.0

f64 = np.float64


@dataclass(frozen=True)
class LBFGSState:
    """The optimizer's state: the L-BFGS memory (``ScaleByLBFGSState``) and
    the value and gradient the last line search ended at
    (``ScaleByZoomLinesearchState``; value inf before the first step)."""

    count: int
    params: torch.Tensor         # (p,) the last iterate the direction was taken at
    updates: torch.Tensor        # (p,) its gradient
    diff_params: torch.Tensor    # (M, p) w_{k+1} − w_k
    diff_updates: torch.Tensor   # (M, p) g_{k+1} − g_k
    weights: torch.Tensor        # (M,) 1 / (sᵀy), 0 where sᵀy = 0
    value: float
    grad: torch.Tensor


def init(params: torch.Tensor, memory_size: int = 10) -> LBFGSState:
    if memory_size < 1:
        raise ValueError("memory_size must be >= 1")
    z = torch.zeros_like(params)
    mem = torch.zeros((memory_size,) + params.shape, dtype=params.dtype, device=params.device)
    return LBFGSState(count=0, params=z, updates=z, diff_params=mem, diff_updates=mem.clone(),
                      weights=torch.zeros(memory_size, dtype=params.dtype, device=params.device),
                      value=float("inf"), grad=z)


def _precondition(updates, dw, du, rho, scale, memory_idx: int) -> torch.Tensor:
    """The two-loop product P·u (``transform._precondition_by_lbfgs``): the
    right products over the memory from the newest pair back, the initial
    scale, the left products forward."""
    M = rho.shape[0]
    indices = [(memory_idx + i) % M for i in range(M)]
    vec, alphas = updates, {}
    for idx in reversed(indices):
        alphas[idx] = rho[idx] * torch.dot(dw[idx], vec)
        vec = vec + (-alphas[idx]) * du[idx]
    vec = scale * vec
    for idx in indices:
        beta = rho[idx] * torch.dot(du[idx], vec)
        vec = vec + (alphas[idx] - beta) * dw[idx]
    return vec


def direction(grad: torch.Tensor, state: LBFGSState, params: torch.Tensor):
    """``scale_by_lbfgs``'s update: store the newest pair, then return
    (−P·g, the state with the new memory)."""
    M = state.weights.shape[0]
    memory_idx, prev_idx = state.count % M, (state.count - 1) % M
    if state.count > 0:
        dp, du = params - state.params, grad - state.updates
        vdot = torch.dot(du, dp)
        weight = torch.where(vdot == 0.0, torch.zeros_like(vdot), 1.0 / vdot)
    else:
        dp, du = torch.zeros_like(params), torch.zeros_like(grad)
        weight = torch.zeros((), dtype=params.dtype, device=params.device)
    dws, dus, rho = state.diff_params.clone(), state.diff_updates.clone(), state.weights.clone()
    dws[prev_idx], dus[prev_idx], rho[prev_idx] = dp, du, weight
    if state.count > 0:
        num, den = torch.dot(du, dp), torch.dot(du, du)
        scale = torch.where(den > 0.0, num / den, torch.ones_like(den))
    else:
        scale = torch.clamp(1.0 / torch.linalg.vector_norm(grad), max=1.0)
    precond = _precondition(grad, dws, dus, rho, scale, memory_idx)
    return -1.0 * precond, replace(state, count=state.count + 1, params=params, updates=grad,
                                   diff_params=dws, diff_updates=dus, weights=rho)


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Critical point of the cubic through (a, fa), (b, fb), (c, fc) with
    slope fpa at a; NaN where it has none (``linesearch._cubicmin``)."""
    C = fpa
    db, dc = b - a, c - a
    denom = (db * dc) ** 2 * (db - dc)
    r1, r2 = fb - fa - C * db, fc - fa - C * dc
    A = (dc ** 2 * r1 + (-(db ** 2)) * r2) / denom
    B = ((-(dc ** 3)) * r1 + db ** 3 * r2) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + np.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """Critical point of the quadratic through (a, fa), (b, fb) with slope
    fpa at a (``linesearch._quadmin``)."""
    B = (fb - fa - fpa * (b - a)) / ((b - a) ** 2)
    return a - fpa / (2.0 * B)


def _decrease_error(stepsize, value, slope, value_init, slope_init):
    err = value - value_init - SLOPE_RTOL * stepsize * slope_init
    approx = np.maximum(slope - (2 * SLOPE_RTOL - 1.0) * slope_init,
                        value - value_init - APPROX_DEC_RTOL * np.abs(value_init))
    err = np.maximum(np.minimum(approx, err), 0.0)
    return f64(np.inf) if np.isnan(err) else err


def _curvature_error(slope, slope_init):
    err = np.maximum(np.abs(slope) - CURV_RTOL * np.abs(slope_init), 0.0)
    return f64(np.inf) if np.isnan(err) else err


def zoom_linesearch(value_and_grad: Callable, params: torch.Tensor, updates: torch.Tensor,
                    value: float, grad: torch.Tensor) -> Tuple[float, float, torch.Tensor, int]:
    """A step size along ``updates`` from ``params`` by optax's zoom line
    search with ``lbfgs()``'s settings. ``value_and_grad(x)`` returns (the
    loss as a 0-d tensor, its gradient). Returns (step size, the value and
    gradient there, the number of evaluations)."""
    with np.errstate(all="ignore"):     # numpy scalars: IEEE inf and NaN, as jnp
        return _zoom(value_and_grad, params, updates, f64(value), grad)


def _zoom(value_and_grad, params, updates, value, grad):
    def on_line(stepsize):
        v, g = value_and_grad(params + float(stepsize) * updates)
        return f64(float(v)), g, f64(float(torch.dot(g, updates)))

    slope = f64(float(torch.dot(updates, grad)))
    value_init, slope_init = value, slope
    st = dict(count=0, stepsize=f64(0.0), value=value, grad=grad, slope=slope,
              decrease_error=f64(np.inf), interval_found=False, done=False, failed=False,
              low=f64(0.0), value_low=value, slope_low=slope,
              high=f64(0.0), value_high=value, slope_high=slope,
              cubic_ref=f64(0.0), value_cubic_ref=value,
              safe_stepsize=f64(0.0), safe_value=value, safe_grad=grad)
    while not (st["done"] or st["failed"]):
        it = st["count"]
        if not st["interval_found"]:
            # the search for an interval (Algorithm 3.5)
            prev = (st["stepsize"], st["value"], st["slope"])
            new = f64(1.0) if it == 0 else INCREASE_FACTOR * prev[0]
            v, g, s = on_line(new)
            dec = _decrease_error(new, v, s, value_init, slope_init)
            err = np.maximum(dec, _curvature_error(s, slope_init))
            if dec <= TOL:
                st.update(safe_stepsize=new, safe_value=v, safe_grad=g)
            high_to_new = bool((dec > 0.0) | ((v >= prev[1]) & (it > 0)))
            low_to_new = bool((s >= 0.0) & (not high_to_new))
            lo, hi = ((new, v, s), prev) if low_to_new else (prev, (new, v, s))
            found = high_to_new or low_to_new or bool(err <= TOL)
            done = bool(err <= TOL)
            st.update(count=it + 1, stepsize=new, value=v, grad=g, slope=s, decrease_error=dec,
                      interval_found=found, done=done,
                      failed=(it + 1 >= MAX_LINESEARCH_STEPS) and not done,
                      low=lo[0], value_low=lo[1], slope_low=lo[2],
                      high=hi[0], value_high=hi[1], slope_high=hi[2],
                      cubic_ref=lo[0], value_cubic_ref=lo[1])
        else:
            # the zoom into the interval (Algorithm 3.6)
            low, vlow, slow = st["low"], st["value_low"], st["slope_low"]
            high, vhigh, shigh = st["high"], st["value_high"], st["slope_high"]
            delta = np.abs(high - low)
            left, right = np.minimum(high, low), np.maximum(high, low)
            cubic = _cubicmin(low, vlow, slow, high, vhigh, st["cubic_ref"], st["value_cubic_ref"])
            use_cubic = bool((cubic > left + 0.2 * delta) & (cubic < right - 0.2 * delta))
            quad = _quadmin(low, vlow, slow, high, vhigh)
            use_quad = (not use_cubic) and bool((quad > left + 0.1 * delta)
                                                & (quad < right - 0.1 * delta))
            middle = cubic if use_cubic else quad if use_quad else (low + high) / 2.0
            v, g, s = on_line(middle)
            dec = _decrease_error(middle, v, s, value_init, slope_init)
            err = np.maximum(dec, _curvature_error(s, slope_init))
            if (dec <= TOL) and (v < st["safe_value"]):
                st.update(safe_stepsize=middle, safe_value=v, safe_grad=g)
            done = bool(err <= TOL)
            high_to_middle = bool((dec > 0.0) | (v >= vlow))
            high_to_low = bool(s * (high - low) >= 0.0) and not high_to_middle
            new_high = (middle, v, s) if high_to_middle else (high, vhigh, shigh)
            if high_to_low:
                new_high = (low, vlow, slow)
            new_low = (low, vlow, slow) if high_to_middle else (middle, v, s)
            ref = (high, vhigh) if (high_to_middle or high_to_low) else (low, vlow)
            failed = ((it + 1 >= MAX_LINESEARCH_STEPS)
                      or bool((delta <= INTERVAL_THRESHOLD) & (st["safe_stepsize"] > 0.0)))
            st.update(count=it + 1, stepsize=middle, value=v, grad=g, slope=s, decrease_error=dec,
                      done=done, failed=failed and not done,
                      low=new_low[0], value_low=new_low[1], slope_low=new_low[2],
                      high=new_high[0], value_high=new_high[1], slope_high=new_high[2],
                      cubic_ref=ref[0], value_cubic_ref=ref[1])
        if st["failed"] and (st["safe_stepsize"] > 0.0 or np.isinf(st["decrease_error"])):
            # the best step with sufficient decrease, or none (``_try_safe_step``)
            st.update(stepsize=st["safe_stepsize"], value=st["safe_value"],
                      grad=st["safe_grad"])
    return float(st["stepsize"]), float(st["value"]), st["grad"], st["count"]


def step(value_and_grad: Callable, params: torch.Tensor, state: LBFGSState):
    """One ``optax.lbfgs()`` iteration from ``params``: the value and
    gradient (the last search's where finite, as
    ``value_and_grad_from_state``), the direction, the line search. Returns
    (the new iterate, the new state, the value at ``params``, evaluations)."""
    evals = 0
    if np.isfinite(state.value):
        value, grad = state.value, state.grad
    else:
        v, grad = value_and_grad(params)
        value, evals = float(v), 1
    d, lb_state = direction(grad, state, params)
    stepsize, v_new, g_new, n = zoom_linesearch(value_and_grad, params, d, value, grad)
    new = params + stepsize * d
    return new, replace(lb_state, value=v_new, grad=g_new), value, evals + n
