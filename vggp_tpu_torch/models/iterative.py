"""Matrix-free (CG) posterior means and pathwise samples for very large
inducing grids, any number of axes (port of ``vggp_tpu/models/iterative.py``).

The dense collapsed GP (``models.sgpr``) forms B = I + AAᵀ, an (m, m)
matrix: at 512×512 cells (m = 262 144) B alone is 275 GB. The posterior
means need only the action of σ²Kuu + KufKufᵀ:

    m_u = Kuu w,   (σ² Kuu + Kuf Kufᵀ) w = Kuf y,
    E[f*] = Kuf(x*)ᵀ w,      E[v] = Kvu w,

and every factor there is structured. Kuu acts through the per-axis
``kuu_matvec`` (the FFT Toeplitz matvec of the uniform cell features, the
banded one of the B1 splines) along each Kronecker axis; Kuf and Kufᵀ
through the per-axis (m_i, n) blocks, contracted one axis at a time so that
neither the (m, n) joint block nor an (m_1, m_2, n) intermediate is ever
built. A Jacobi- or KMS-Woodbury-preconditioned CG solve (``ops.cg``) then
gives the gridded product's mean in O(iters·(m log m + n·m)) time.

Per-cell uncertainty is matrix-free too: :func:`pathwise_q_v_samples` and
:func:`pathwise_q_dv_samples` draw Matheron posterior functionals over exact
prior-path functionals (``sampling``) at one Kuu solve and one G solve a
sample, all samples' solves batched as the columns of one CG.

The conventions of the other heads hold: training conditions on y − m(x)
and the mean's cell integrals are added back, noise goes through
``common.obs_noise`` (per-output noise solves the weighted system
G = c·Kuu + Kuf R Kufᵀ), and the coregion axis works everywhere. Every
function that runs a CG solve runs under ``torch.no_grad()``: the JAX
package's ``while_loop`` is not reverse-differentiable either.

    w = iterative.solve_w(spec, params, X, y)
    fmean = iterative.posterior_mean_from_w(spec, params, xstar, w)
    vmean = iterative.q_v_mean_from_w(spec, params, grid_axes, w)

The data axis may be split over processes (``parallel.cg``): the solves and
samplers take a :class:`DataShard`, which sums each contraction over n
across the processes; without one every result is the unsharded one, bit
for bit.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Sequence

import torch

from vggp_tpu_torch import config, kernels, sampling
from vggp_tpu_torch.config import highest_precision
from vggp_tpu_torch.features import CellIntegralFeature
from vggp_tpu_torch.models import common
from vggp_tpu_torch.ops.cg import cg_solve, pcg_solve
from vggp_tpu_torch.ops.chol import safe_cholesky
from vggp_tpu_torch.ops.kms import kms_gamma_rho, kms_tinv_matvec

Params = dict


class DataShard(NamedTuple):
    """This process's contiguous block of the data points when the data axis
    is split over a process group (``parallel.cg``): rows [start, start + n
    local) of the ``n`` points. ``reduce`` sums a tensor over the group; it
    is applied after every sum over the data axis, so that every process
    holds the whole contraction. ``gather`` concatenates the blocks along
    the last axis in rank order. The solves run on the reduced, replicated
    w-tensors, so every process takes the same iterates and the same host
    decisions."""

    reduce: Callable[[torch.Tensor], torch.Tensor]
    gather: Callable[[torch.Tensor], torch.Tensor]
    n: int
    start: int


def _reduce(shard: DataShard | None, t: torch.Tensor) -> torch.Tensor:
    """The sum over the whole data axis of a per-process partial sum ``t``."""
    return t if shard is None else shard.reduce(t)


def _check_spec(spec, pathwise: bool = False) -> None:
    """Reject a spec without aligned per-axis (kinds, features) tuples (the
    sum, additive and free-point models) with a pointer to the dense heads.
    The coregion axis is eligible everywhere; ``pathwise`` restricts
    nothing and is kept for the JAX package's signature."""
    del pathwise
    kinds = getattr(spec, "kinds", None)
    feats = getattr(spec, "features", None)
    if (not isinstance(kinds, tuple) or not isinstance(feats, tuple)
            or len(kinds) != len(feats) or not kinds):
        raise ValueError(
            "the iterative (matrix-free CG) path needs a plain per-axis "
            "spec (aligned kinds/features tuples, e.g. SGPRSpec/SVGPSpec); "
            f"got {type(spec).__name__} — use the dense heads for "
            "sum-of-kernels, additive, and free-Z models")


def _noise_weights(spec, params: Params, X: torch.Tensor, shard: DataShard | None = None):
    """(c, r) of the normal equations under noise D = diag(dᵢ):
    G = c·Kuu + Kuf R Kufᵀ, G w = Kuf R y, R = diag(c/dᵢ). A scalar noise
    gives (σ², None), the classic σ²Kuu + KufKufᵀ; a per-output vector gives
    c = mean(dᵢ) over all the points, which keeps the Jacobi diagonal
    balanced (any c > 0 gives the same w)."""
    dvec = common.obs_noise(spec, params, X)
    if dvec.dim() == 0:
        return dvec, None
    c = torch.mean(dvec) if shard is None else shard.reduce(torch.sum(dvec)) / shard.n
    return c, c / dvec


def _axis_shape(spec):
    return tuple(f.m for f in spec.features)


def _kuf_blocks(spec, params: Params, X: torch.Tensor):
    """Per-axis (m_i, n) cross-covariance blocks (the Khatri–Rao factors)."""
    X2 = X if X.dim() == 2 else X.reshape(-1, 1)
    return tuple(spec.features[i].Kuf(spec.kinds[i], common.axis_params(params, i), X2[:, i])
                 for i in range(spec.ndim))


# The Khatri–Rao contractions take a w-tensor with any leading batch axes.
# Each contracts one axis at a time, (W @ B_d) ∘ B_{d−1} summed over m_{d−1}
# and so on: an einsum of three operands would build the (m_1, m_2, n)
# intermediate (69 GB at 512², n = 65 536).


def _kufT_w(blocks, W: torch.Tensor) -> torch.Tensor:
    """Kufᵀ w for the w-tensor (…, m_1, …, m_d) → (…, n)."""
    lead = W.shape[:W.dim() - len(blocks)]
    n = blocks[0].shape[1]
    t = W.reshape(*lead, -1, blocks[-1].shape[0]) @ blocks[-1]
    for B in reversed(blocks[:-1]):
        t = torch.sum(t.reshape(*lead, -1, B.shape[0], n) * B, dim=-2)
    return t.reshape(*lead, n)


def _kuf_v(blocks, v: torch.Tensor) -> torch.Tensor:
    """Kuf v for v (…, n) → the (…, m_1, …, m_d) tensor."""
    lead = v.shape[:-1]
    n = v.shape[-1]
    t = v[..., None, :]
    for B in blocks[:-1]:
        t = (t[..., None, :] * B).reshape(*lead, -1, n)
    out = t @ blocks[-1].T
    return out.reshape(*lead, *(B.shape[0] for B in blocks))


def _along_axes(W: torch.Tensor, fns) -> torch.Tensor:
    """Apply fns[i], a map of (m_i, r) → (g_i, r), along axis i of the
    tensor W (…, m_1, …, m_d)."""
    lead = W.dim() - len(fns)
    for i, fn in enumerate(fns):
        ax = lead + i
        Wm = torch.movedim(W, ax, 0)
        out = fn(Wm.reshape(Wm.shape[0], -1))
        W = torch.movedim(out.reshape(out.shape[0], *Wm.shape[1:]), 0, ax)
    return W


def _matmul_along(mats):
    return [lambda v, K=K: K @ v for K in mats]


def _kuu_apply(spec, params: Params):
    """W ↦ (⊗_i Kuu_i) @ w, each axis's structured operator along its axis
    (built once: the Toeplitz rows and their transforms, the bands)."""
    ops = [spec.features[i].kuu_operator(spec.kinds[i], common.axis_params(params, i))
           for i in range(spec.ndim)]
    return lambda W: _along_axes(W, ops)


def _kuu_diag_flat(spec, params: Params) -> torch.Tensor:
    """diag(⊗ Kuu_i) as a flat (m,) vector."""
    kdiag = None
    for i in range(spec.ndim):
        di = spec.features[i].kuu_diag(spec.kinds[i], common.axis_params(params, i))
        kdiag = di if kdiag is None else (kdiag[:, None] * di[None, :]).reshape(-1)
    return kdiag


def _on_columns(shape, fn):
    """A map of flat (m, k) columns through ``fn`` on the (k, *shape) tensor."""
    def apply(V):
        k = V.shape[1]
        return fn(V.T.reshape(k, *shape)).reshape(k, -1).T
    return apply


def _kms_precond_eligible(spec, n: int) -> bool:
    """The static gate of the KMS preconditioners (see ``config``)."""
    if not config.CG_KMS_PRECOND or n > config.CG_KMS_MAX_POINTS:
        return False
    return all(kind == "matern12" and isinstance(feat, CellIntegralFeature) and feat.uniform
               for kind, feat in zip(spec.kinds, spec.features))


def _u_floor(dtype) -> float:
    """5·√eps: below u = δ/ℓ ≈ √eps the tridiagonal KMS⁻¹ apply is noise."""
    return 5.0 * math.sqrt(float(torch.finfo(dtype).eps))


def _kms_axes(spec, params: Params, u_floor: float):
    """(Π γ_i, [(ρ_i, 1 − ρ_i²)], min_i δ_i/ℓ_i) of the per-axis KMS
    decompositions Kuu_i = γ_i·KMS(ρ_i) + η_i·I."""
    gam, axes, u_min = 1.0, [], None
    for i in range(spec.ndim):
        p = common.axis_params(params, i)
        gamma, rho, s2 = kms_gamma_rho(spec.features[i].delta, p["variance"],
                                       p["lengthscale"], u_floor=u_floor)
        gam = gam * gamma
        axes.append((rho, s2))
        u_i = spec.features[i].delta / p["lengthscale"]
        u_min = u_i if u_min is None else torch.minimum(u_min, u_i)
    return gam, axes, u_min


def _kms_tinv(axes, W: torch.Tensor) -> torch.Tensor:
    """⊗ KMS(ρ_i)⁻¹ applied along the axes of W (…, m_1, …, m_d)."""
    return _along_axes(W, [lambda v, a=a: kms_tinv_matvec(*a, v) for a in axes])


def _kms_woodbury_precond(spec, params: Params, blocks):
    """M⁻¹ for M = σ²·⊗(γᵢ KMS(ρᵢ)) + Kuf Kufᵀ, a near-exact surrogate of G
    (they differ by the O(δ/ℓ)-relative η·I terms of Kuu = γ·KMS(ρ) + η·I).

    Woodbury: M⁻¹r = M₀⁻¹r − M₀⁻¹Kuf S⁻¹ Kufᵀ M₀⁻¹ r with
    S = I + Kufᵀ M₀⁻¹ Kuf. Every M₀⁻¹ apply is per-axis closed-form
    tridiagonal matvecs; S is the Hadamard product of per-axis (n, n)
    quadratic forms (the Khatri–Rao columns factor the Kronecker inverse),
    factorized once. Every product is full fp32 (the caller's
    ``highest_precision``): the result is the small difference of two
    ‖M₀⁻¹r‖-sized terms, and a noisy build can turn bᵀM⁻¹b negative.
    """
    shape = _axis_shape(spec)
    n = blocks[0].shape[1]
    gam, axes, _ = _kms_axes(spec, params, _u_floor(blocks[0].dtype))
    gam_total = params["noise"] * gam

    def m0_inv(W):
        return _kms_tinv(axes, W) / gam_total

    had = None
    for (rho, s2), Bi in zip(axes, blocks):
        Gi = Bi.T @ kms_tinv_matvec(rho, s2, Bi)            # (n, n)
        had = Gi if had is None else had * Gi
    S = torch.eye(n, dtype=had.dtype, device=had.device) + had / gam_total
    LS = safe_cholesky(S, 1e-10)

    def minv(W):
        W = m0_inv(W)
        t = torch.cholesky_solve(_kufT_w(blocks, W).T, LS).T      # (k, n)
        return W - m0_inv(_kuf_v(blocks, t))

    return _on_columns(shape, minv)


def _g_apply(spec, params: Params, blocks, noise_c, weights, shard: DataShard | None = None):
    """W ↦ G W = c·(⊗Kuu) W + Kuf R Kufᵀ W on w-tensors (…, m_1, …, m_d)."""
    kuu = _kuu_apply(spec, params)

    def apply(W):
        fw = _kufT_w(blocks, W)
        if weights is not None:
            fw = fw * weights
        return noise_c * kuu(W) + _reduce(shard, _kuf_v(blocks, fw))
    return apply


def _g_solver(spec, params: Params, blocks, tol, maxiter, noise_c=None, weights=None,
              shard: DataShard | None = None):
    """The preconditioned CG solver of G = c·Kuu + Kuf R Kufᵀ
    (:func:`_noise_weights`; homoscedastic R = I, c = σ²): a function of the
    flat right-hand sides (m, k) → G⁻¹ rhs (m, k) (``return_info`` as
    ``ops.cg``), whose ``preconditioner`` names the one it runs.

    KMS-Woodbury PCG where :func:`_kms_precond_eligible` admits the spec
    and its gates admit ℓ and the dtype (``config``); Jacobi-preconditioned
    PCG where the spec is eligible but they do not; Jacobi-scaled CG
    otherwise. The JAX package computes both preconditioners of an eligible
    spec and selects with a device scalar; the selection is constant across
    a solve, so the gates are read to the host once here and only the
    chosen branch is built: the same iterates.

    Under a ``shard`` the KMS gate reads the number of all the points, and
    the Woodbury's S, which couples every pair of points, is built from the
    gathered Kuf blocks and applied whole on every process.
    """
    p_noise = params["noise"] if noise_c is None else noise_c
    shape = _axis_shape(spec)
    matvec = _on_columns(shape, _g_apply(spec, params, blocks, p_noise, weights, shard))

    # Jacobi on the exact diagonal σ²·diag(Kuu) + rowsum(Kuf²): a Kuu·1
    # row-sum proxy fails the B1 spline Gram, whose rows cancel.
    sq = [bk * bk for bk in blocks]
    if weights is not None:
        sq[0] = sq[0] * weights[None, :]
    ones = torch.ones_like(blocks[0][0])
    rowsum = _reduce(shard, _kuf_v(sq, ones)).reshape(-1)
    d = p_noise * _kuu_diag_flat(spec, params) + rowsum
    d = torch.clamp(d, min=torch.finfo(blocks[0].dtype).tiny)[:, None]

    n = blocks[0].shape[1] if shard is None else shard.n
    if weights is None and _kms_precond_eligible(spec, n):
        u_floor = _u_floor(blocks[0].dtype)
        _, _, u_min = _kms_axes(spec, params, u_floor)
        # float32 never takes the Woodbury (see config)
        use_kms = blocks[0].dtype != torch.float32 and bool(u_min >= u_floor)
        if use_kms:
            every = blocks if shard is None else tuple(shard.gather(B) for B in blocks)
            precond, name = _kms_woodbury_precond(spec, params, every), "kms-woodbury"
        else:
            precond, name = (lambda r: r / d), "jacobi-pcg"

        def solve(b, return_info=False):
            return pcg_solve(matvec, b, precond, tol=tol, maxiter=maxiter,
                             return_info=return_info)
    else:
        s, name = 1.0 / torch.sqrt(d), "jacobi"

        def solve(b, return_info=False):
            out = cg_solve(lambda v: s * matvec(s * v), s * b, tol=tol, maxiter=maxiter,
                           return_info=return_info)
            return (s * out[0], *out[1:]) if return_info else s * out

    solve.preconditioner = name
    return solve


def _kuu_solver(spec, params: Params, kuu_tol, kuu_maxiter):
    """The sampler's solver of ⊗Kuu on flat columns (m, k): KMS-preconditioned
    PCG when every axis is a uniform Matérn-1/2 cell feature (the
    ⊗(γᵢ⁻¹KMSᵢ⁻¹) preconditioner is exact up to the O(δ/ℓ)-relative η terms),
    with Jacobi in its place where u = δ/ℓ falls below the u floor (the gate
    read once, as in :func:`_g_solver`); Jacobi-scaled CG otherwise."""
    shape = _axis_shape(spec)
    kdiag = _kuu_diag_flat(spec, params)
    kdiag = torch.clamp(kdiag, min=torch.finfo(kdiag.dtype).tiny)[:, None]
    mv = _on_columns(shape, _kuu_apply(spec, params))
    if _kms_precond_eligible(spec, 0):
        u_floor = _u_floor(kdiag.dtype)
        gam, axes, u_min = _kms_axes(spec, params, u_floor)
        if bool(u_min >= u_floor):
            minv = _on_columns(shape, lambda W: _kms_tinv(axes, W) / gam)
        else:
            minv = lambda r: r / kdiag
        return lambda b: pcg_solve(mv, b, minv, tol=kuu_tol, maxiter=kuu_maxiter)
    s = 1.0 / torch.sqrt(kdiag)
    return lambda b: s * cg_solve(lambda v: s * mv(s * v), s * b, tol=kuu_tol,
                                  maxiter=kuu_maxiter)


@torch.no_grad()
@highest_precision
def solve_w(spec, params: Params, X: torch.Tensor, y: torch.Tensor,
            tol: float | None = None, maxiter: int = 1000, return_info: bool = False,
            shard: DataShard | None = None):
    """w = (σ² Kuu + Kuf Kufᵀ)⁻¹ Kuf y by preconditioned CG (:func:`_g_solver`).

    Any number of Kronecker axes; w is FLAT (m,) in the ``numpy.kron``
    row-major order. ``tol=None`` takes the dtype-aware default of
    ``ops.cg``. Conditions on y − m(x) when a mean is learned; per-output
    noise solves the weighted system (:func:`_noise_weights`). With
    ``return_info`` returns (w, {"iterations", "rel_resid",
    "preconditioner"}), reading the first two to the host. Under a ``shard``
    X and y are this process's block of the points and w is every
    process's.
    """
    _check_spec(spec)
    y = y.reshape(-1) - common.mean_fn(spec, params, X)
    blocks = _kuf_blocks(spec, params, X)
    noise_c, weights = _noise_weights(spec, params, X, shard)
    yw = y if weights is None else y * weights
    b = _reduce(shard, _kuf_v(blocks, yw)).reshape(-1, 1)
    solve = _g_solver(spec, params, blocks, tol, maxiter, noise_c=noise_c, weights=weights,
                      shard=shard)
    w, iters, rel = solve(b, return_info=True)
    if return_info:
        return w[:, 0], {"iterations": int(iters[0]), "rel_resid": float(rel[0]),
                         "preconditioner": solve.preconditioner}
    return w[:, 0]


@torch.no_grad()
@highest_precision
def relative_residual(spec, params: Params, X: torch.Tensor, y: torch.Tensor,
                      w: torch.Tensor, shard: DataShard | None = None) -> torch.Tensor:
    """‖Kuf R y − G w‖ / ‖Kuf R y‖ of a :func:`solve_w` result, in the
    dtype of ``params`` (pass float64 ones to read a float32 w's true
    residual)."""
    _check_spec(spec)
    y = y.reshape(-1) - common.mean_fn(spec, params, X)
    blocks = _kuf_blocks(spec, params, X)
    noise_c, weights = _noise_weights(spec, params, X, shard)
    yw = y if weights is None else y * weights
    b = _reduce(shard, _kuf_v(blocks, yw))
    r = b - _g_apply(spec, params, blocks, noise_c, weights, shard)(
        w.to(b.dtype).reshape(b.shape))
    return torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b)


@highest_precision
def posterior_mean_from_w(spec, params: Params, xstar: torch.Tensor,
                          w: torch.Tensor) -> torch.Tensor:
    """E_q[f(x*)] = m(x*) + Kuf(x*)ᵀ w for a :func:`solve_w` result."""
    blocks = _kuf_blocks(spec, params, xstar)
    return (_kufT_w(blocks, w.reshape(_axis_shape(spec)))
            + common.mean_fn(spec, params, xstar))


@highest_precision
def q_v_mean_from_w(spec, params: Params, grid_axes: Sequence[CellIntegralFeature],
                    w: torch.Tensor) -> torch.Tensor:
    """E_q[v] = ∫m + Kvu w for a :func:`solve_w` result (flat, kron row-major
    over the grid cells; a learned mean adds its exact cell integrals)."""
    kvu = common.grid_kvu(spec, params, grid_axes)
    out = _along_axes(w.reshape(_axis_shape(spec)), _matmul_along(kvu)).reshape(-1)
    return out + common.grid_mean(spec, params, grid_axes)


@highest_precision
def q_dv_mean_from_w(spec, params: Params, grid_axes: Sequence[CellIntegralFeature],
                     axis: int, w: torch.Tensor) -> torch.Tensor:
    """E_q[∫_cell ∂f/∂x_axis] = Kv'u w, the gridded-gradient product's mean
    (flat, kron row-major over cells): face differences of Kuf on ``axis``
    (``common.grad_grid_kvu``), exact for every kind. A constant mean has no
    derivative, so nothing adds back."""
    _check_spec(spec)
    kvu = common.grad_grid_kvu(spec, params, grid_axes, axis)
    return _along_axes(w.reshape(_axis_shape(spec)), _matmul_along(kvu)).reshape(-1)


@highest_precision
def posterior_grad_mean_from_w(spec, params: Params, xstar: torch.Tensor, axis: int,
                               w: torch.Tensor) -> torch.Tensor:
    """E_q[∂f/∂x_axis (x*)] = (∂Kuf)ᵀ w; needs a once-differentiable kind on
    ``axis`` (the face-difference head covers every kind)."""
    _check_spec(spec)
    orders = common.normalize_deriv_orders(spec, axis)
    X2 = xstar if xstar.dim() == 2 else xstar.reshape(-1, 1)
    blocks = tuple(
        (spec.features[i].dKuf_dx if orders[i] else spec.features[i].Kuf)(
            spec.kinds[i], common.axis_params(params, i), X2[:, i])
        for i in range(spec.ndim))
    return _kufT_w(blocks, w.reshape(_axis_shape(spec)))


# --------------------------------------------------------------------------- #
# Matrix-free uncertainty: pathwise samples through CG solves
# (``iterative.py:377-704``)
#
# Under Titsias's optimal q, a joint prior path with exact inducing and grid
# functionals updates as
#   v_s = v_prior + Kvu G⁻¹ Kuf (y − Kfuᵀ Kuu⁻¹ u_prior − ε_s),
#   G = σ²Kuu + Kuf Kufᵀ,  ε_s ~ N(0, σ²I),
# by the push-through identity Kuu⁻¹Kuf(Qff + σ²I)⁻¹ = G⁻¹Kuf; its moments
# are those of sgpr.q_v up to the prior path's F features and the CG
# tolerance. A sample costs one Kuu solve and one G solve.
# --------------------------------------------------------------------------- #


# A batch of k columns through the Khatri–Rao contractions holds a
# (k, m / m_d, n) intermediate: the sampler splits its columns so that one
# stays within SAMPLER_CHUNK_BYTES (each column's iterate does not depend on
# the split).
SAMPLER_CHUNK_BYTES = 4 << 30


def _in_chunks(fn, X: torch.Tensor, row_bytes: int):
    """fn over slices of X's first axis, as many rows a slice as keep
    ``row_bytes`` each within SAMPLER_CHUNK_BYTES."""
    chunk = max(1, SAMPLER_CHUNK_BYTES // row_bytes)
    if X.shape[0] <= chunk:
        return fn(X)
    return torch.cat([fn(part) for part in torch.split(X, chunk)])


@torch.no_grad()
@highest_precision
def pathwise_q_v_samples(
    spec, params: Params, X: torch.Tensor, y: torch.Tensor,
    grid_axes: Sequence[CellIntegralFeature], gen: torch.Generator,
    n_samples: int = 64, n_features: int = 1024,
    tol: float | None = None, maxiter: int = 1000,
    kuu_tol: float | None = None, kuu_maxiter: int = 2000,
    antithetic: bool = False, return_prior: bool = False, shard: DataShard | None = None,
):
    """(S, ∏g_i) joint posterior draws of the gridded product, matrix-free.

    ``n_features`` sets the prior path's fidelity (its only approximation
    beside the CG tolerance); ``kuu_maxiter`` bounds the Kuu solve, whose
    conditioning grows like (ℓ/δ)². ``antithetic=True`` draws S/2 (path, ε)
    pairs and emits both signs, ordered pair by pair: the update is affine,
    so each pair mirrors around Kvu·w and the sample mean is exact for any
    S. ``return_prior=True`` also returns the (S, ∏g_i) prior-path grid
    functionals, whose exact second moment diag(Kvv) is the control variate
    of :func:`q_v_pathwise`. Draws come from ``gen`` (see ``sampling``);
    under a ``shard`` every process draws every point's ε from ``gen`` in
    the same state and keeps its own block, so the draws are the unsharded
    run's.
    """
    _check_spec(spec)
    kvu_blocks = common.grid_kvu(spec, params, grid_axes)
    co = spec.kinds.index(kernels.COREGION_KIND) if kernels.COREGION_KIND in spec.kinds else None

    def prior_grid_fn(om, ph, amp, LB):
        if LB is None:
            return sampling.prior_grid_integral_sample(om, ph, amp, grid_axes)
        return sampling.prior_grid_integral_sample_multioutput(om, ph, amp, LB, co, grid_axes)

    samples, priors = _matheron_grid_samples(
        spec, params, X, y, gen, n_samples=n_samples, n_features=n_features, tol=tol,
        maxiter=maxiter, kuu_tol=kuu_tol, kuu_maxiter=kuu_maxiter, antithetic=antithetic,
        kvu_blocks=kvu_blocks, prior_grid_fn=prior_grid_fn, shard=shard)
    samples = samples + common.grid_mean(spec, params, grid_axes)
    return (samples, priors) if return_prior else samples


def _matheron_grid_samples(spec, params: Params, X, y, gen, *, n_samples, n_features, tol,
                           maxiter, kuu_tol, kuu_maxiter, antithetic, kvu_blocks,
                           prior_grid_fn, shard=None):
    """The Matheron sampler over CG solves for any linear grid functional:
    (samples, priors), both (S, ∏g_i), in the zero-mean GP's space.
    ``kvu_blocks`` are the per-axis Cov(functional, u) factors;
    ``prior_grid_fn(om, ph, amp, LB)`` evaluates the functional on a prior
    path (LB the chol(B) mixer of a coregion spec, else None).

    The draws come first, one (path, ε) per sample in turn; then one
    batched Kuu solve, and the G solves of every sample (both signs of an
    antithetic pair) as the columns of one CG.
    """
    if antithetic and n_samples % 2:
        raise ValueError(f"antithetic needs an even n_samples, got {n_samples}")
    co = spec.kinds.index(kernels.COREGION_KIND) if kernels.COREGION_KIND in spec.kinds else None
    y = y.reshape(-1) - common.mean_fn(spec, params, X)
    blocks = _kuf_blocks(spec, params, X)
    shape = _axis_shape(spec)
    noise = common.obs_noise(spec, params, X)
    noise_c, weights = _noise_weights(spec, params, X, shard)
    g_solve = _g_solver(spec, params, blocks, tol, maxiter, noise_c=noise_c, weights=weights,
                        shard=shard)
    kuu_solve = _kuu_solver(spec, params, kuu_tol, kuu_maxiter)
    # ε of every point, so that the generator stays in step with the
    # unsharded run's; this process keeps its block
    eps_shape = y.shape if shard is None else (shard.n,)
    rows = slice(None) if shard is None else slice(shard.start, shard.start + y.shape[0])

    u_ps, v_ps, epss = [], [], []
    for _ in range(n_samples // 2 if antithetic else n_samples):
        if co is None:
            om, ph, amp = sampling.prior_paths(gen, spec, params, n_features)
            u_ps.append(sampling.prior_inducing_sample(om, ph, amp, spec, params))
            v_ps.append(prior_grid_fn(om, ph, amp, None).reshape(-1))
        else:
            om, ph, amp, LB, _ = sampling.prior_paths_multioutput(gen, spec, params, n_features)
            u_ps.append(sampling.prior_inducing_sample_multioutput(om, ph, amp, LB, co, spec,
                                                                   params))
            v_ps.append(prior_grid_fn(om, ph, amp, LB).reshape(-1))
        epss.append(torch.sqrt(noise) * sampling.normal(gen, eps_shape, y)[rows])
    v_p, eps = torch.stack(v_ps), torch.stack(epss)

    def project(U):
        """The DTC-projected prior paths at the data, Kfuᵀ Kuu⁻¹ u_p."""
        t = kuu_solve(U.reshape(U.shape[0], -1).T).T
        return _kufT_w(blocks, t.reshape(-1, *shape))

    def update(resid):
        """Kvu G⁻¹ Kuf R resid for rows of residuals (k, n)."""
        if weights is not None:
            resid = resid * weights
        rhs = _reduce(shard, _kuf_v(blocks, resid)).reshape(resid.shape[0], -1)
        alpha = g_solve(rhs.T).T.reshape(-1, *shape)
        return _along_axes(alpha, _matmul_along(kvu_blocks)).reshape(resid.shape[0], -1)

    row_bytes = math.prod(shape[:-1]) * y.shape[0] * y.element_size()
    f_proj = _in_chunks(project, torch.stack(u_ps), row_bytes)
    delta = f_proj + eps
    if antithetic:
        # (S/2, 2, …) in pair order: (v_p, f_proj, ε) and its negation
        resid = torch.stack([y - delta, y + delta], dim=1).reshape(n_samples, -1)
        v_p = torch.stack([v_p, -v_p], dim=1).reshape(n_samples, -1)
    else:
        resid = y - delta
    return v_p + _in_chunks(update, resid, row_bytes), v_p


def q_v_pathwise(spec, params: Params, X: torch.Tensor, y: torch.Tensor,
                 grid_axes: Sequence[CellIntegralFeature], gen: torch.Generator,
                 n_samples: int = 64, n_features: int = 1024, antithetic: bool = False,
                 control_variate: bool = False, **cg_kwargs) -> common.Gaussian:
    """Gaussian(mean, var) summary of :func:`pathwise_q_v_samples`, the
    matrix-free ``sgpr.q_v(..., full_cov=False)``: the unbiased sample
    variance, MC-accurate to about √(2/S) relative.

    ``antithetic``: mirrored pairs, an exact mean for any S.
    ``control_variate``: the prior-path functionals v_p have the known
    per-cell second moment diag(Kvv), so var̂(v_s) − β·(var̂(v_p) − diag Kvv)
    removes the shared prior-path noise, with β per cell the regression
    coefficient Cov(s², p²)/Var(p²) from the same draws, clipped to [0, 1]
    (β → 1 far from the data, → 0 where the correction cancels the path),
    and the result floored at 1e-6·diag(Kvv).
    """
    samples, priors = pathwise_q_v_samples(
        spec, params, X, y, grid_axes, gen, n_samples=n_samples, n_features=n_features,
        antithetic=antithetic, return_prior=True, **cg_kwargs)
    return pathwise_moments(spec, params, grid_axes, samples, priors, control_variate)


def pathwise_moments(spec, params: Params, grid_axes: Sequence[CellIntegralFeature],
                     samples: torch.Tensor, priors: torch.Tensor,
                     control_variate: bool = False) -> common.Gaussian:
    """The moments of :func:`q_v_pathwise` from draws that
    :func:`pathwise_q_v_samples` returned with ``return_prior=True``."""
    mean = torch.mean(samples, dim=0)
    var = torch.var(samples, dim=0, correction=1)
    if control_variate:
        kvv_diag = None
        for i, g in enumerate(grid_axes):
            di = g.kuu_diag(spec.kinds[i], common.axis_params(params, i))
            kvv_diag = di if kvv_diag is None else (kvv_diag[:, None] * di[None, :]).reshape(-1)
        var_p = torch.var(priors, dim=0, correction=1)
        s2 = (samples - mean[None, :]) ** 2
        p2 = (priors - torch.mean(priors, dim=0)[None, :]) ** 2
        ds2 = s2 - torch.mean(s2, dim=0)[None, :]
        dp2 = p2 - torch.mean(p2, dim=0)[None, :]
        beta = (torch.sum(ds2 * dp2, dim=0)
                / torch.clamp(torch.sum(dp2 * dp2, dim=0), min=torch.finfo(var.dtype).tiny))
        beta = torch.clamp(beta, 0.0, 1.0)
        var = var - beta * (var_p - kvv_diag)
        var = torch.maximum(var, 1e-6 * kvv_diag)
    return common.Gaussian(mean=mean, var=var)


@torch.no_grad()
@highest_precision
def pathwise_q_dv_samples(
    spec, params: Params, X: torch.Tensor, y: torch.Tensor,
    grid_axes: Sequence[CellIntegralFeature], axis: int, gen: torch.Generator,
    n_samples: int = 64, n_features: int = 1024,
    tol: float | None = None, maxiter: int = 1000,
    kuu_tol: float | None = None, kuu_maxiter: int = 2000,
    antithetic: bool = False, return_prior: bool = False, shard: DataShard | None = None,
):
    """(S, ∏g_i) joint posterior draws of the gridded-gradient product
    ∫_cell ∂f/∂x_axis: the sampler of :func:`pathwise_q_v_samples` with
    face differences on ``axis`` (``common.grad_grid_kvu``,
    ``sampling.prior_grid_grad_sample``). A constant mean has no
    derivative, so nothing adds back."""
    _check_spec(spec)
    axis = common.canonical_axis(spec, axis)
    if spec.kinds[axis] == kernels.COREGION_KIND:
        raise ValueError("cannot differentiate along the discrete output axis")
    kvu_blocks = common.grad_grid_kvu(spec, params, grid_axes, axis)
    co = spec.kinds.index(kernels.COREGION_KIND) if kernels.COREGION_KIND in spec.kinds else None

    def prior_grid_fn(om, ph, amp, LB):
        if LB is None:
            return sampling.prior_grid_grad_sample(om, ph, amp, grid_axes, axis)
        return sampling.prior_grid_grad_sample_multioutput(om, ph, amp, LB, co, grid_axes,
                                                           axis)

    samples, priors = _matheron_grid_samples(
        spec, params, X, y, gen, n_samples=n_samples, n_features=n_features, tol=tol,
        maxiter=maxiter, kuu_tol=kuu_tol, kuu_maxiter=kuu_maxiter, antithetic=antithetic,
        kvu_blocks=kvu_blocks, prior_grid_fn=prior_grid_fn, shard=shard)
    return (samples, priors) if return_prior else samples


def q_dv_pathwise(spec, params: Params, X: torch.Tensor, y: torch.Tensor,
                  grid_axes: Sequence[CellIntegralFeature], axis: int, gen: torch.Generator,
                  n_samples: int = 64, n_features: int = 1024, antithetic: bool = False,
                  **cg_kwargs) -> common.Gaussian:
    """Gaussian(mean, var) summary of :func:`pathwise_q_dv_samples`, the
    matrix-free ``sgpr.q_dv(..., full_cov=False)``."""
    samples = pathwise_q_dv_samples(spec, params, X, y, grid_axes, axis, gen,
                                    n_samples=n_samples, n_features=n_features,
                                    antithetic=antithetic, **cg_kwargs)
    return common.Gaussian(mean=torch.mean(samples, dim=0),
                           var=torch.var(samples, dim=0, correction=1))


def posterior_mean_cg(spec, params: Params, X: torch.Tensor, y: torch.Tensor,
                      xstar: torch.Tensor, tol: float | None = None,
                      maxiter: int = 1000) -> torch.Tensor:
    """E_q[f(x*)] = Kuf(x*)ᵀ w, as ``sgpr.posterior(...).mean``."""
    w = solve_w(spec, params, X, y, tol, maxiter)
    return posterior_mean_from_w(spec, params, xstar, w)


def q_v_mean_cg(spec, params: Params, X: torch.Tensor, y: torch.Tensor,
                grid_axes: Sequence[CellIntegralFeature], tol: float | None = None,
                maxiter: int = 1000) -> torch.Tensor:
    """E_q[v] = Kvu w, as ``sgpr.q_v(...).mean``, with Kuu entering through
    structured matvecs only."""
    w = solve_w(spec, params, X, y, tol, maxiter)
    return q_v_mean_from_w(spec, params, grid_axes, w)
