"""Conjugate gradients with a caller's matvec (port of ``vggp_tpu/ops/cg.py``).

The matrix-free solves of ``models.iterative``. Both solvers take one
right-hand side (m,) or a batch of them as the columns of an (m, k) array,
and the matvec and preconditioner act on the same shape. Each column runs
its own iteration and stops on its own test: a column that has stopped
keeps its state through a device-side select while the others go on, so a
batched solve gives each column the iterate it gets alone (a vmapped
``lax.while_loop`` in the JAX package). The host reads the "any column still
running" flag once every :data:`CHECK_EVERY` iterations, not every
iteration; the iterations run past the last column's stop change nothing.
:data:`COUNTS` records the solves, loop iterations and host reads.
"""

from __future__ import annotations

from typing import Callable

import torch

# Iterations between host reads of the running flag.
CHECK_EVERY = 8

# Solves, loop iterations and host reads since the last reset_counts().
COUNTS = {"solves": 0, "iterations": 0, "host_syncs": 0}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def default_tol(dtype) -> float:
    """max(1e-8, 50·eps): float32 CG stagnates around 1e-6 relative, where a
    fixed 1e-8 would burn every iteration."""
    return max(1e-8, 50.0 * float(torch.finfo(dtype).eps))


def _columns(b: torch.Tensor):
    return (b.reshape(-1, 1), True) if b.dim() == 1 else (b, False)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b, dim=0)


def _run(state, step, running, maxiter: int):
    """Iterate ``step`` on ``state`` while any column of ``running(state)``
    is set: the host reads that flag every :data:`CHECK_EVERY` iterations."""
    COUNTS["solves"] += 1
    it = 0
    while it < maxiter:
        if it % CHECK_EVERY == 0:
            COUNTS["host_syncs"] += 1
            if not bool(running(state).any()):
                break
        state = step(state)
        it += 1
    COUNTS["iterations"] += it
    return state


def cg_solve(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    tol: float | None = None,
    maxiter: int = 1000,
    x0: torch.Tensor | None = None,
    return_info: bool = False,
):
    """Solve A x = b for PSD A given only ``matvec``.

    Stops a column on its relative residual ‖r‖ ≤ tol·‖b‖ or at ``maxiter``
    iterations. ``tol=None`` takes :func:`default_tol` of b's dtype. A
    breakdown (pᵀAp ≤ 0, A numerically indefinite) stops the column at its
    current iterate rather than dividing by a tiny denominator.

    With ``return_info=True`` returns ``(x, iters, rel_resid)``, the latter
    two per column ((k,), or scalars for a vector b); else x alone.
    """
    B, squeeze = _columns(b)
    if tol is None:
        tol = default_tol(B.dtype)
    x = torch.zeros_like(B) if x0 is None else x0.reshape(B.shape).clone()
    r = B - matvec(x)
    bnorm2 = torch.clamp(_dot(B, B), min=torch.finfo(B.dtype).tiny)
    tol2 = (tol * tol) * bnorm2
    rs = _dot(r, r)
    k = torch.zeros(B.shape[1], dtype=torch.int64, device=B.device)

    def running(s):
        return (s[3] > tol2) & (s[4] < maxiter)

    def step(s):
        x, r, p, rs, k = s
        active = running(s)
        ap = matvec(p)
        denom = _dot(p, ap)
        ok = denom > 0
        alpha = torch.where(ok, rs / torch.where(ok, denom, 1.0), 0.0)
        x_new = x + alpha * p
        r_new = r - alpha * ap
        # breakdown: keep the current iterate, and the column stops
        rs_new = torch.where(ok, _dot(r_new, r_new), 0.0)
        p_new = r_new + (rs_new / rs) * p
        # the columns that have stopped keep their state
        return (torch.where(active, x_new, x), torch.where(active, r_new, r),
                torch.where(active, p_new, p), torch.where(active, rs_new, rs), k + active)

    x, r, _, _, k = _run((x, r, r, rs, k), step, running, maxiter)
    x = x[:, 0] if squeeze else x
    if return_info:
        rel = torch.sqrt(_dot(r, r) / bnorm2)
        return (x, k[0], rel[0]) if squeeze else (x, k, rel)
    return x


def pcg_solve(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    precond: Callable[[torch.Tensor], torch.Tensor],
    tol: float | None = None,
    maxiter: int = 1000,
    return_info: bool = False,
):
    """Preconditioned CG: solve A x = b given ``matvec`` and an SPD
    approximate inverse ``precond`` (z = M⁻¹ r).

    The contracts of :func:`cg_solve`: the stop on the TRUE residual
    ‖r‖ ≤ tol·‖b‖ (not the preconditioned one, so the answer's quality does
    not depend on M), the dtype-aware default tol, the breakdown exit (a
    column also stops when rᵀM⁻¹r ≤ 0). With ``precond`` the identity this
    is :func:`cg_solve`.
    """
    B, squeeze = _columns(b)
    if tol is None:
        tol = default_tol(B.dtype)
    x = torch.zeros_like(B)
    r = B
    z = precond(r)
    rz = _dot(r, z)
    bnorm2 = torch.clamp(_dot(B, B), min=torch.finfo(B.dtype).tiny)
    tol2 = (tol * tol) * bnorm2
    k = torch.zeros(B.shape[1], dtype=torch.int64, device=B.device)

    def running(s):
        _, r, _, rz, k = s
        return (_dot(r, r) > tol2) & (rz > 0) & (k < maxiter)

    def step(s):
        x, r, p, rz, k = s
        active = running(s)
        ap = matvec(p)
        denom = _dot(p, ap)
        ok = denom > 0
        alpha = torch.where(ok, rz / torch.where(ok, denom, 1.0), 0.0)
        x_new = x + alpha * p
        r_new = r - alpha * ap
        z = precond(r_new)
        rz_new = torch.where(ok, _dot(r_new, z), 0.0)
        p_new = z + (rz_new / torch.where(rz > 0, rz, 1.0)) * p
        return (torch.where(active, x_new, x), torch.where(active, r_new, r),
                torch.where(active, p_new, p), torch.where(active, rz_new, rz), k + active)

    x, r, _, _, k = _run((x, r, z, rz, k), step, running, maxiter)
    x = x[:, 0] if squeeze else x
    if return_info:
        rel = torch.sqrt(_dot(r, r) / bnorm2)
        return (x, k[0], rel[0]) if squeeze else (x, k, rel)
    return x
