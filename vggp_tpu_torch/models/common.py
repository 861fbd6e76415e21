"""Shared model plumbing of the port (``vggp_tpu/models/common.py``): axis
parameters, jitter policy, the scalar-tangent and dense-factor whitened Kuf,
Khatri–Rao assembly, the grid and gridded-gradient blocks of the serving
heads, the pointwise-gradient blocks, the collapsed (Titsias) bound's
factored state, bound and posterior, and the Gaussian result."""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from vggp_tpu_torch import config, kernels
from vggp_tpu_torch.config import matmul_precision
from vggp_tpu_torch.features import ell_tangent
from vggp_tpu_torch.ops import toeplitz
from vggp_tpu_torch.ops.chol import (F32_MIN_JITTER, PSDFactor, psd_factor, safe_cholesky,
                                    tri_solve)
from vggp_tpu_torch.ops.kron import khatri_rao_rows, kron_dense, kron_diag
from vggp_tpu_torch.tracing import span, traced

Params = Dict


@dataclass
class Gaussian:
    """A multivariate normal result: mean, and either the (n, n) covariance
    or its (n,) diagonal."""

    mean: torch.Tensor
    cov: torch.Tensor = None  # (n, n) when materialized
    var: torch.Tensor = None  # (n,) diagonal when cov is not materialized

    def variance(self) -> torch.Tensor:
        return self.var if self.var is not None else torch.diagonal(self.cov)

    def stddev(self) -> torch.Tensor:
        return torch.sqrt(self.variance())


def axis_params(params: Params, i: int) -> Params:
    return params["axes"][i]


def shift_mean(g: Gaussian, delta) -> Gaussian:
    """Gaussian with ``delta`` added to the mean (0.0 → unchanged)."""
    if isinstance(delta, float) and delta == 0.0:
        return g
    return Gaussian(mean=g.mean + delta, cov=g.cov, var=g.var)


def floor_var(var: torch.Tensor, ref_diag: torch.Tensor) -> torch.Tensor:
    """Floor variances at 1e-6 of the prior diagonal: the subtracted forms
    k_diag − Σa² + Σt² can dip below zero in float32 by roundoff."""
    return torch.maximum(var, 1e-6 * ref_diag)


# float32 Kuu jitter floors by kernel smoothness (measured in the JAX package).
KIND_JITTER_F32 = {"matern12": 1e-6, "matern32": 1e-4, "matern52": 1e-4, "rbf": 1e-4}


def axis_rel_jitter(spec, kind: str, dtype, feat=None) -> float:
    """Effective relative Kuu jitter for one axis: ``spec.jitter`` in
    float64; in float32 floored at the per-kernel, the global and, given
    ``feat``, the per-feature minimums."""
    jitter = spec.jitter
    if dtype != torch.float64:
        jitter = max(jitter, KIND_JITTER_F32.get(kind, 1e-4), F32_MIN_JITTER)
        if feat is not None:
            jitter = max(jitter, feat.extra_f32_jitter(kind))
    return jitter


def axis_chol_kuu(spec, params: Params, method: str = None) -> Tuple[PSDFactor, ...]:
    """Per-axis PSD factors of Kuu (``common.py:101-119``): the jittered
    Cholesky with the f32 jitter floors of :func:`axis_rel_jitter`, or,
    with ``method`` (default: the spec's ``factor_method``) ``"eigh"``, the
    clamped-eigh factor of the serving heads."""
    if method is None:
        method = getattr(spec, "factor_method", "chol")
    out = []
    for i, (kind, feat) in enumerate(zip(spec.kinds, spec.features)):
        kuu = feat.Kuu(kind, axis_params(params, i))
        out.append(psd_factor(kuu, method=method,
                              jitter=axis_rel_jitter(spec, kind, kuu.dtype, feat)))
    return tuple(out)


def scalar_whiten_eligible(spec, params: Params) -> bool:
    """True when the scalar-tangent whitening applies: Cholesky factors, and
    every axis trained through exactly (variance, lengthscale), i.e. fixed
    bases (a coregion axis has (w, κ) and takes the dense factor)."""
    if not config.SCALAR_WHITEN_VJP:
        return False
    if getattr(spec, "factor_method", "chol") != "chol":
        return False
    return all(set(ax) <= {"variance", "lengthscale"} for ax in params["axes"])


def _kuu_jittered(feat, kind, rel_jitter, ell, var):
    k = feat.Kuu(kind, {"lengthscale": ell, "variance": var})
    k = 0.5 * (k + k.T)
    scale = torch.mean(torch.diagonal(k)) * rel_jitter
    return k + scale * torch.eye(k.shape[0], dtype=k.dtype, device=k.device)


def _kuu_jittered_dl(feat, kind, rel_jitter, ell, var):
    """∂(jittered Kuu)/∂ℓ — what ``common.py:243`` takes by ``jax.jvp``,
    the jitter mean(diag K)·rel's own ℓ-dependence included.

    Matérn-1/2 on a uniform mesh has it in closed form: the Gram is
    symmetric Toeplitz with a constant diagonal, so the derivative is
    T(row′) + row′[0]·rel·I. Elsewhere it is the forward-mode tangent of
    :func:`_kuu_jittered` (``features.ell_tangent``).
    """
    drow = feat.kuu_first_row_dl(kind, {"lengthscale": ell, "variance": var})
    if drow is None:
        return ell_tangent(lambda t: _kuu_jittered(feat, kind, rel_jitter, t, var), ell)[1]
    dk = toeplitz.sym_toeplitz_dense(drow)
    return dk + (drow[0] * rel_jitter) * torch.eye(dk.shape[0], dtype=dk.dtype,
                                                    device=dk.device)


@traced("vggp.dispatch.finv")
def _finv_of_params(feat, kind, rel_jitter, ell, var):
    """(F⁻¹, band ratio or None) of the jittered Kuu: the closed form of
    ``ops.kms`` where the feature has one (Matérn-1/2 on a uniform mesh) and
    ``config.STRUCTURED_FINV`` is on; otherwise a dense Cholesky and
    triangular inverse."""
    p_lv = {"lengthscale": ell, "variance": var}
    if config.STRUCTURED_FINV:
        closed = feat.inv_chol_kuu_and_ratio(kind, p_lv, rel_jitter)
        if closed is not None:
            fi, ratio = closed
            return fi, (ratio if config.BANDED_WHITEN_APPLY else None)
    K = _kuu_jittered(feat, kind, rel_jitter, ell, var)
    F = torch.linalg.cholesky(K)
    eye = torch.eye(F.shape[0], dtype=F.dtype, device=F.device)
    return torch.linalg.solve_triangular(F, eye, upper=False), None


@traced("vggp.dispatch.whiten")
def _apply_finv(finv, ratio, kuf):
    from vggp_tpu_torch.ops.kms import banded_whiten_apply

    if ratio is None:
        with matmul_precision(config.WHITEN_MATMUL_PRECISION):
            return finv @ kuf
    return banded_whiten_apply(finv, kuf, ratio, config.WHITEN_MATMUL_PRECISION)


def _whitened_kuf_primal(feat, kind, rel_jitter, ell, var, x):
    """a = F⁻¹·Kuf alone: the ``cell_kuf`` kernel and the banded apply."""
    finv, ratio = _finv_of_params(feat, kind, rel_jitter, ell, var)
    kuf = feat.Kuf(kind, {"lengthscale": ell, "variance": var}, x)
    return _apply_finv(finv, ratio, kuf)


def _whitened_kuf_tangent(feat, kind, rel_jitter, ell, var, x):
    """(a, ∂a/∂ℓ) — the forward of ``common.py:236-260`` (``wk_fwd``).

    With M = F⁻¹(∂Kuu)F⁻ᵀ and Φ = strict lower + half diagonal,
    ∂a/∂ℓ = F⁻¹∂Kuf − Φ(M)·a, with ∂Kuu/∂ℓ from :func:`_kuu_jittered_dl`.
    Its products ride ``config.MATMUL_PRECISION`` (fp32), not the gradient
    precision the JAX package gives them: the two (m, n) terms nearly
    cancel, and the ℓ-gradient sums their difference over every point. One
    TF32 product there moved dℓ by 47% in the collapsed bound (m = 4096,
    n = 65 536) and by 4% to 20× in the 512² SVGP under the non-Gaussian
    likelihoods, on an H100.
    """
    prec = config.MATMUL_PRECISION
    with span("vggp.dispatch.tangent"):
        dK = _kuu_jittered_dl(feat, kind, rel_jitter, ell, var)
    finv, ratio = _finv_of_params(feat, kind, rel_jitter, ell, var)
    p_lv = {"lengthscale": ell, "variance": var}
    fused = feat.whitened_kuf_fused(kind, p_lv, finv, ratio, x)
    if fused is not None:
        a, t = fused
    else:
        kuf, dkuf = feat.Kuf_with_dl(kind, p_lv, x)
        a = _apply_finv(finv, ratio, kuf)
        with span("vggp.dispatch.tangent"), matmul_precision(prec):
            t = finv @ dkuf
    with span("vggp.dispatch.tangent"), matmul_precision(prec):
        M = finv @ dK @ finv.T
        Phi = torch.tril(M, -1) + 0.5 * torch.diag(torch.diagonal(M))
        da_dl = t - Phi @ a
    return a, da_dl


class WhitenedKufScalar(torch.autograd.Function):
    """Attaches the scalar-tangent backward of ``common.py:262-266`` to
    a = F⁻¹Kuf and its ℓ-tangent, both computed before: ∂/∂ℓ = Σ ḡ·∂a/∂ℓ
    and ∂/∂σ² = Σ ḡ·a / (2σ²) (a ∝ √σ² for a fixed basis). The points get
    no gradient. (The tangents are taken outside the Function: inside its
    forward, forward-mode AD is off and a dual ℓ would carry no tangent.)

    a and ∂a/∂ℓ are built without a graph, so the backward is exact to
    first order only: asked for a graph of itself (``create_graph``, the
    first pass of a Hessian) it raises. A Hessian takes
    :func:`second_order`'s route instead."""

    @staticmethod
    def forward(ctx, ell, var, a, da_dl):
        ctx.save_for_backward(a, da_dl, var)
        return a

    @staticmethod
    def backward(ctx, g):
        first_order_only("WhitenedKufScalar")
        a, da_dl, var = ctx.saved_tensors
        dl = torch.sum(g * da_dl)
        dv = torch.sum(g * a) / (2.0 * var)
        return dl, dv, None, None


def first_order_only(what: str) -> None:
    """Raise when a first-order-only backward runs under ``create_graph``.
    (``torch.autograd.function.once_differentiable`` does not raise here:
    its error node has no edge to the inputs, so the engine prunes it and a
    Hessian comes back silently short of those terms.)"""
    if torch.is_grad_enabled():
        raise RuntimeError(
            f"{what}'s backward is first-order only and cannot build a graph for a "
            "second derivative; take Hessians inside models.common.second_order()")


_SECOND_ORDER = [0]


@contextlib.contextmanager
def second_order():
    """Inside, :func:`whitened_kuf_scalar` builds a = F⁻¹Kuf by its primal
    route under autograd (the differentiable F⁻¹, ``CellKufOp`` — the
    ``cell_kuf`` kernel forward, a plain-torch backward — and the banded
    apply), and the SVGP's q(f) moments skip ``KronMoments``, so a
    derivative of a derivative is exact: the route of
    ``hyperpost.laplace``'s Hessian. Outside, the first-order backwards
    stay the training path."""
    _SECOND_ORDER[0] += 1
    try:
        yield
    finally:
        _SECOND_ORDER[0] -= 1


def in_second_order() -> bool:
    return _SECOND_ORDER[0] > 0


def whitened_kuf_scalar(feat, kind: str, rel_jitter: float, p: Params,
                        x: torch.Tensor) -> torch.Tensor:
    """a = F⁻¹ Kuf for a fixed-basis feature.

    When a gradient is wanted (grad mode on and ℓ or σ² requiring grad) the
    ℓ-tangent is computed alongside a, through ``cell_kuf_with_dl`` or, at
    large batch, the fused kernel (a forward-mode tangent for the other
    kinds) — as JAX's ``custom_vjp`` runs only ``wk_fwd`` under
    differentiation. Otherwise, and inside :func:`second_order`, only the
    primal is built: the ``cell_kuf`` kernel and the banded apply, no
    tangents.
    """
    ell, var = p["lengthscale"], p["variance"]
    if (not in_second_order() and torch.is_grad_enabled()
            and (ell.requires_grad or var.requires_grad)):
        with torch.no_grad():
            a, da_dl = _whitened_kuf_tangent(feat, kind, rel_jitter, ell.detach(),
                                             var.detach(), x)
        with span("vggp.dispatch.tangent"):   # its backward is the tangent's
            return WhitenedKufScalar.apply(ell, var, a, da_dl)
    return _whitened_kuf_primal(feat, kind, rel_jitter, ell, var, x)


def axis_whitened_kuf_scalar(spec, params: Params, X: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Per-axis A_i = F_i⁻¹ Kuf_i via :func:`whitened_kuf_scalar`."""
    if X.dim() == 1:
        X = X[:, None]
    dtype = params["noise"].dtype
    out = []
    for i, (kind, feat) in enumerate(zip(spec.kinds, spec.features)):
        rel = axis_rel_jitter(spec, kind, dtype, feat)
        out.append(whitened_kuf_scalar(feat, kind, rel, axis_params(params, i), X[:, i]))
    return tuple(out)


def axis_whitened_kuf(spec, params: Params, chols, X: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Per-axis A_i = F_i⁻¹ Kuf_i(x_i), (m_i, n) each, through dense factors."""
    if X.dim() == 1:
        X = X[:, None]
    return tuple(chols[i].whiten(feat.Kuf(kind, axis_params(params, i), X[:, i]))
                 for i, (kind, feat) in enumerate(zip(spec.kinds, spec.features)))


def khatri_rao_all(blocks: Sequence[torch.Tensor]) -> torch.Tensor:
    """(Π m_i, n) column-wise Kronecker of the per-axis (m_i, n) blocks."""
    out = blocks[0]
    for b in blocks[1:]:
        out = khatri_rao_rows(out, b)
    return out


def kdiag(spec, params: Params, X: torch.Tensor) -> torch.Tensor:
    """diag K_ff — the product of the per-axis Gram diagonals (the
    stationary variance, or B[p, p] on a coregion axis)."""
    if X.dim() == 1:
        X = X[:, None]
    v = torch.ones((X.shape[0],), dtype=X.dtype, device=X.device)
    for i, kind in enumerate(spec.kinds):
        v = v * kernels.axis_kdiag(kind, axis_params(params, i), X[:, i])
    return v


def gram_full(spec, params: Params, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Dense K(x1, x2): the product over axes of the 1-D Grams (the
    coregion axis's gather of B included)."""
    if x1.dim() == 1:
        x1 = x1[:, None]
    if x2.dim() == 1:
        x2 = x2[:, None]
    out = None
    for i, kind in enumerate(spec.kinds):
        g = kernels.axis_gram(kind, axis_params(params, i), x1[:, i], x2[:, i])
        out = g if out is None else out * g
    return out


def grid_kvu(spec, params: Params, grid_axes) -> Tuple[torch.Tensor, ...]:
    """Per-axis (g_i, m_i) Kvu blocks between grid cells and the features."""
    return tuple(feat.Kvu(kind, axis_params(params, i), grid_axes[i])
                 for i, (kind, feat) in enumerate(zip(spec.kinds, spec.features)))


def grid_kvv(spec, params: Params, grid_axes, dense: bool = True):
    """Per-axis grid-cell prior covariances (the grid feature's Kuu); their
    Kronecker product when ``dense``."""
    blocks = tuple(grid_axes[i].Kuu(kind, axis_params(params, i))
                   for i, kind in enumerate(spec.kinds))
    return kron_dense(blocks) if dense else blocks


# Gridded gradients: v'_c = ∫_cell ∂f/∂x_axis collapses on that axis, by the
# fundamental theorem of calculus, to a face difference of point evaluations
# tensored with the other axes' cell integrals (``common.py:349-365``).


def canonical_axis(spec, axis: int) -> int:
    """Normalize a (possibly negative) axis index; raises when out of range."""
    nd = len(spec.kinds)
    if not -nd <= axis < nd:
        raise ValueError(f"axis {axis} out of range for a {nd}-axis model")
    return axis % nd


# Pointwise gradient observables ∂f/∂x_axis (``common.py:381-465``): for the
# separable kernel only the axis's factor is differentiated, so
# Cov(∂f(x), u) = (∂Kuf_axis) ⊙ Π_{i≠axis} Kuf_i and
# Var[∂f(x)] = −k_axis″(0) · Π_{i≠axis} σ²_i. They need a once-differentiable
# kind on the axis (kernels.require_differentiable).


def grad_kdiag(spec, params: Params, X: torch.Tensor, axis: int) -> torch.Tensor:
    """diag Cov[∂_axis f] = −k_axis″(0) · Π_{i≠axis} diag K_i."""
    axis = canonical_axis(spec, axis)
    if X.dim() == 1:
        X = X[:, None]
    p_ax = axis_params(params, axis)
    v = kernels.grad_variance(spec.kinds[axis], p_ax["variance"], p_ax["lengthscale"])
    out = torch.ones((X.shape[0],), dtype=X.dtype, device=X.device) * v
    for i, kind in enumerate(spec.kinds):
        if i != axis:
            out = out * kernels.axis_kdiag(kind, axis_params(params, i), X[:, i])
    return out


def grad_gram_full(spec, params: Params, x1: torch.Tensor, x2: torch.Tensor,
                   axis: int) -> torch.Tensor:
    """Dense Cov(∂_axis f(x1), ∂_axis f(x2)) = (−k_axis″) · Π_{i≠axis} k_i."""
    axis = canonical_axis(spec, axis)
    if x1.dim() == 1:
        x1 = x1[:, None]
    if x2.dim() == 1:
        x2 = x2[:, None]
    out = None
    for i, kind in enumerate(spec.kinds):
        p = axis_params(params, i)
        if i == axis:
            g = kernels.grad_gram_1d(kind, x1[:, i], x2[:, i], p["variance"], p["lengthscale"])
        else:
            g = kernels.axis_gram(kind, p, x1[:, i], x2[:, i])
        out = g if out is None else out * g
    return out


def normalize_deriv_orders(spec, entry) -> Tuple[int, ...]:
    """An int axis j → the one-hot order tuple; a tuple gives the order per
    axis (0, 1 or 2). Each differentiated axis's kind must support its order."""
    if isinstance(entry, int):
        entry = canonical_axis(spec, entry)
        orders = tuple(1 if i == entry else 0 for i in range(len(spec.kinds)))
    else:
        orders = tuple(int(o) for o in entry)
        if len(orders) != len(spec.kinds):
            raise ValueError(f"derivative orders {orders} must have one entry per axis "
                             f"({len(spec.kinds)})")
    for i, o in enumerate(orders):
        if o == 1:
            kernels.require_differentiable(spec.kinds[i])
        elif o == 2:
            kernels.require_twice_differentiable(spec.kinds[i])
        elif o != 0:
            raise ValueError(f"derivative order {o} not supported (0, 1, 2)")
    return orders


def axis_whitened_deriv_kuf(spec, params: Params, chols, X: torch.Tensor,
                            orders) -> Tuple[torch.Tensor, ...]:
    """Per-axis whitened blocks F_i⁻¹ ∂^{o_i}Kuf_i: the cross-covariance of
    the whitened inducing coordinates with the mixed partial Π ∂^{o_i}f."""
    if X.dim() == 1:
        X = X[:, None]
    out = []
    for i, (kind, feat) in enumerate(zip(spec.kinds, spec.features)):
        p = axis_params(params, i)
        blk = (feat.Kuf, feat.dKuf_dx, feat.dKuf_dx2)[orders[i]](kind, p, X[:, i])
        out.append(chols[i].whiten(blk))
    return tuple(out)


def axis_whitened_dkuf(spec, params: Params, chols, X: torch.Tensor,
                       axis: int) -> Tuple[torch.Tensor, ...]:
    """Per-axis whitened blocks, axis ``axis`` carrying F⁻¹ ∂Kuf/∂x."""
    orders = normalize_deriv_orders(spec, axis)
    return axis_whitened_deriv_kuf(spec, params, chols, X, orders)


def grad_grid_kvu(spec, params: Params, grid_axes, axis: int) -> Tuple[torch.Tensor, ...]:
    """Per-axis Kv'u blocks of the gridded-gradient product along ``axis``:
    face differences of Kuf at that axis's cell edges, plain Kvu elsewhere."""
    axis = canonical_axis(spec, axis)
    out = []
    for i, (kind, feat) in enumerate(zip(spec.kinds, spec.features)):
        p = axis_params(params, i)
        if i == axis:
            kue = feat.Kuf(kind, p, grid_axes[i].mesh_j(p))   # (m, g + 1)
            out.append((kue[:, 1:] - kue[:, :-1]).T)          # (g, m)
        else:
            out.append(feat.Kvu(kind, p, grid_axes[i]))
    return tuple(out)


def _face_diff_gram(kind: str, p: Params, grid) -> torch.Tensor:
    """(g, g) Cov of the face differences f(β_c) − f(α_c) on the grid's mesh,
    as −2·kdiff0 double differences so the dominant k(0) never enters:
    Cov(Δ_i, Δ_j) = [D(β_i−α_j) + D(α_i−β_j)] − [D(β_i−β_j) + D(α_i−α_j)]
    with D(r) = k(0) − k(r)."""
    mesh = grid.mesh_j(p)
    a, b = mesh[:-1], mesh[1:]
    var, ell = p["variance"], p["lengthscale"]

    def D(u, w):
        return kernels.kdiff0(kind, u[:, None] - w[None, :], var, ell)

    return (D(b, a) + D(a, b)) - (D(b, b) + D(a, a))


def grad_grid_kvv(spec, params: Params, grid_axes, axis: int, dense: bool = True):
    """Per-axis prior covariance blocks of the gridded-gradient product."""
    axis = canonical_axis(spec, axis)
    blocks = tuple(_face_diff_gram(kind, axis_params(params, i), grid_axes[i]) if i == axis
                   else grid_axes[i].Kuu(kind, axis_params(params, i))
                   for i, kind in enumerate(spec.kinds))
    return kron_dense(blocks) if dense else blocks


def _per_output(spec, leaf: torch.Tensor, X: torch.Tensor, what: str):
    """A scalar leaf as it is; a vector leaf (P,) gathered at each row's
    output index, read from the coregion axis's column and clipped into
    range as the JAX package's gather clips it (``kernels.clip_index``).
    Without a coregion axis a vector is a ValueError, worded as in the JAX
    package (``what`` names the leaf)."""
    if leaf.dim() == 0:
        return leaf
    try:
        i = spec.kinds.index(kernels.COREGION_KIND)
    except ValueError:
        raise ValueError(f"vector params['{what}'] is {'a ' if what == 'mean' else ''}"
                         f"per-output {what} and requires a 'coregion' axis to carry the "
                         f"output index") from None
    if X.dim() == 1:
        X = X[:, None]
    return leaf[kernels.clip_index(kernels._as_index(X[:, i]), leaf.shape[0])]


def mean_fn(spec, params: Params, X: torch.Tensor):
    """Prior mean m(x): the learned ``params["mean"]``, a constant or a
    per-output vector gathered by the coregion axis's index column, or 0.0
    when the model learns none. The model is f = m + g with g the zero-mean
    GP of the inducing machinery: every training head subtracts m from y,
    every predictive head adds it back, and the gridded heads add its cell
    integrals (:func:`grid_mean`); a constant has no gradient, so the
    gradient heads see none."""
    m = params.get("mean")
    return 0.0 if m is None else _per_output(spec, m, X, "mean")


def grid_mean(spec, params: Params, grid_axes):
    """Exact cell integrals of the mean over a product grid, a flat
    (Π g_i,) vector in the ``numpy.kron`` order: the Kronecker product of
    the cell widths of each integral axis and, on the coregion axis, the
    per-output mean (or ones, with the constant as a factor); 0.0 when the
    model learns no mean."""
    m = params.get("mean")
    if m is None:
        return 0.0
    vecs = []
    for kind, g in zip(spec.kinds, grid_axes):
        if kind == kernels.COREGION_KIND:
            ones = torch.ones((g.n_outputs,), dtype=m.dtype, device=m.device)
            vecs.append(ones * m if m.dim() == 1 else ones)
        else:
            vecs.append(torch.as_tensor(np.diff(np.asarray(g.mesh)), dtype=m.dtype,
                                        device=m.device))
    out = kron_diag(vecs)
    return out * m if m.dim() == 0 else out


def obs_noise(spec, params: Params, X: torch.Tensor):
    """Observation noise variance: the scalar (homoscedastic) ``noise``, or
    a per-output vector (P,) gathered by the coregion axis's index column
    (an (n,) vector; every consumer broadcasts either)."""
    return _per_output(spec, params["noise"], X, "noise")


# The collapsed bound (``common.py:607-690``), in the stable factored form
#   A = F⁻¹Kuf/σ (the axis blocks joined by ``combine``: Khatri–Rao for the
#   Kronecker models, a concatenation for the additive one), B = I + AAᵀ,
#   L_B = chol(B), c = L_B⁻¹A y/σ; σ² per observation under per-output noise.


def gram_accumulated(A: torch.Tensor, y: torch.Tensor):
    """(B, b) = (I + A·Aᵀ, A·y) with the n-term sums accumulated in float64
    and returned in A's dtype: on an H100, cuBLAS's float32 Gram over
    n = 65 536 points is 4e-5 off float64, which the Cholesky of B
    (condition ~1e7) carried into the heads 27× further than the CPU's
    float32 did (tools/torch_collapsed_precision.py, ROADMAP queue 3). There
    the float64 tensor-core rate equals the float32 CUDA-core one."""
    A64 = A.double()
    B = torch.eye(A.shape[0], dtype=torch.float64, device=A.device) + A64 @ A64.T
    return B.to(A.dtype), (A64 @ y.double()).to(A.dtype)


def factored_state(spec, params: Params, X: torch.Tensor, y: torch.Tensor,
                   with_chols: bool = True, combine=khatri_rao_all):
    """(chols, A, L_B, c, y) of the collapsed bound, y the residual.

    ``chols`` are the per-axis dense Kuu factors the heads whiten with. The
    JAX package always builds them and leaves XLA to drop them where unused;
    run eagerly they would cost a Cholesky per axis per step, so on the
    scalar-tangent path (fixed bases) they are built only ``with_chols``
    (None otherwise). The state's A whitens through the closed-form F⁻¹, a
    head's query block through ``chols``, as in the JAX package.
    """
    y = y.reshape(-1) - mean_fn(spec, params, X)
    sigma = torch.sqrt(obs_noise(spec, params, X))
    if scalar_whiten_eligible(spec, params):
        chols = axis_chol_kuu(spec, params) if with_chols else None
        blocks = axis_whitened_kuf_scalar(spec, params, X)
    else:
        chols = axis_chol_kuu(spec, params)
        blocks = axis_whitened_kuf(spec, params, chols, X)
    A = combine(blocks) / sigma                 # (m, n); an (n,) σ scales the columns
    B, Ay = gram_accumulated(A, y / sigma)      # the n-term sums in float64
    LB = safe_cholesky(B, 1e-12)                # float32: the 1e-6 floor, relative to mean diag(B)
    return chols, A, LB, tri_solve(LB, Ay), y


def nonneg(x: torch.Tensor) -> torch.Tensor:
    """max(x, 0) with ``jnp.maximum``'s gradient: a tie splits it evenly
    (½ at x = 0), as ``torch.maximum`` does and ``torch.clamp`` does not."""
    return torch.maximum(x, torch.zeros_like(x))


def collapsed_elbo(spec, params: Params, X: torch.Tensor, y: torch.Tensor,
                   combine=khatri_rao_all, kdiag_fn=kdiag) -> torch.Tensor:
    """The collapsed (Titsias) evidence lower bound, a scalar; diag K_ff is
    ``kdiag_fn`` (the product of the axis variances for a separable kernel,
    their sum for an additive one). Per-output noise D = diag(σ²_i) enters
    exactly: every σ² is the observation's own."""
    _, A, LB, c, y = factored_state(spec, params, X, y, with_chols=False, combine=combine)
    noise = obs_noise(spec, params, X).expand(y.shape[0])
    kff = kdiag_fn(spec, params, X)
    bound = -0.5 * torch.sum(torch.log(2.0 * math.pi * noise))
    bound = bound - torch.sum(torch.log(torch.diagonal(LB)))
    bound = bound - 0.5 * torch.sum(y * y / noise)
    bound = bound + 0.5 * torch.sum(c * c)
    # the trace gap tr(D⁻¹(Kff − Qff)) ≥ 0: clamp the float32 cancellation
    # error so that it can never turn into a reward
    return bound - 0.5 * nonneg(torch.sum(kff / noise) - torch.sum(A * A))


def conditional(w: torch.Tensor, LB: torch.Tensor, c: torch.Tensor, kss_fn, kdiag_fn,
                full_cov: bool, noise=0.0) -> Gaussian:
    """The collapsed conditional from the whitened cross block w (m, n*) of
    a factored state: mean (L_B⁻¹w)ᵀc, cov K** − wᵀw + (L_B⁻¹w)ᵀ(L_B⁻¹w)
    with ``kss_fn()`` the prior K**, or for ``full_cov=False`` the floored
    diagonal from ``kdiag_fn()``; ``noise`` (a scalar or per point) added."""
    tmp = tri_solve(LB, w)
    mean = tmp.T @ c
    if full_cov:
        cov = kss_fn() - w.T @ w + tmp.T @ tmp
        return Gaussian(mean=mean, cov=cov + noise * torch.eye(cov.shape[0], dtype=cov.dtype,
                                                               device=cov.device))
    kss = kdiag_fn()
    var = kss - torch.sum(w * w, dim=0) + torch.sum(tmp * tmp, dim=0)
    return Gaussian(mean=mean, var=floor_var(var, kss) + noise)


def collapsed_posterior(spec, params: Params, state, xstar: torch.Tensor,
                        full_cov: bool = False, predictive: bool = False,
                        kdiag_fn=kdiag, gram_fn=gram_full, blocks_fn=None,
                        combine=khatri_rao_all) -> Gaussian:
    """q(f*) from a factored state: w = F⁻¹Kuf* through the state's dense
    factors, mean = (L_B⁻¹w)ᵀc, cov = K** − wᵀw + (L_B⁻¹w)ᵀ(L_B⁻¹w).

    The gradient heads pass ``blocks_fn`` (F⁻¹∂Kuf in place of F⁻¹Kuf) and
    the prior's ``kdiag_fn`` / ``gram_fn`` of ∂f, and reuse the same algebra;
    they see no prior mean (∂m = 0)."""
    chols, A, LB, c = state[:4]
    w = combine((blocks_fn or axis_whitened_kuf)(spec, params, chols, xstar))
    g = conditional(w, LB, c, lambda: gram_fn(spec, params, xstar, xstar),
                    lambda: kdiag_fn(spec, params, xstar), full_cov,
                    obs_noise(spec, params, xstar) if predictive else 0.0)
    return g if blocks_fn is not None else shift_mean(g, mean_fn(spec, params, xstar))


def init_tree(kinds, features, per_output_noise: bool, learn_mean: bool, dtype,
              device, n_outputs: int = None) -> Params:
    """The initial ``{"axes", "noise"[, "mean"]}`` of a per-axis spec, on
    ``device`` (resolved by the caller): σ² = ℓ = 1 on each continuous axis
    and the feature's own parameters (a point feature's z; a coregion axis's
    W and κ, and no σ² or ℓ); noise 0.1, a (P,) vector with
    ``per_output_noise`` (which needs a coregion axis of P outputs: a
    ValueError without one, as in the JAX package); the mean 0, a (P,)
    vector on a model with a coregion axis. ``n_outputs`` given, P is that
    (the exact GP's spec field) and nothing raises."""
    def full(shape, v):
        return torch.full(shape, v, dtype=dtype, device=device)

    axes = tuple(({} if kind == kernels.COREGION_KIND else
                  {"variance": full((), 1.0), "lengthscale": full((), 1.0)})
                 | f.init_params(dtype, device) for kind, f in zip(kinds, features))
    outputs = lambda: ((features[kinds.index(kernels.COREGION_KIND)].n_outputs,)
                       if n_outputs is None else (n_outputs,))
    out = {"axes": axes, "noise": full(outputs() if per_output_noise else (), 0.1)}
    if learn_mean:
        out["mean"] = full(outputs() if kernels.COREGION_KIND in kinds else (), 0.0)
    return out


def _parameter_dicts(axes) -> nn.ModuleList:
    return nn.ModuleList(
        nn.ParameterDict({k: nn.Parameter(v.detach().clone()) for k, v in ax.items()})
        for ax in axes)


def module_params(module: nn.Module, raw: Params) -> None:
    """Give ``module`` the raw tree's leaves as ``nn.Parameter``s in the
    layout of the JAX parameter tree: ``axes`` → one ``ParameterDict`` per
    axis (a sum of kernels: ``components``, one such list per component),
    ``noise`` (a scalar or a per-output vector), and the learned ``mean``
    and a free-point model's points ``z`` where the tree has them."""
    if "components" in raw:
        module.components = nn.ModuleList(_parameter_dicts(cp["axes"])
                                          for cp in raw["components"])
    else:
        module.axes = _parameter_dicts(raw["axes"])
    for key in ("noise", "mean", "z"):
        setattr(module, key, nn.Parameter(raw[key].detach().clone()) if key in raw else None)


def module_raw_params(module: nn.Module) -> Params:
    """The nested raw tree of :func:`module_params`, its leaves the module's
    parameters."""
    if hasattr(module, "components"):
        out = {"components": tuple({"axes": tuple(dict(ax.items()) for ax in cp)}
                                   for cp in module.components)}
    else:
        out = {"axes": tuple(dict(ax.items()) for ax in module.axes)}
    out["noise"] = module.noise
    for key in ("mean", "z"):
        if getattr(module, key) is not None:
            out[key] = getattr(module, key)
    return out


class HeldDataModule(nn.Module):
    """A full-batch model as a module (the collapsed and exact GPs): the
    training data as buffers, and the raw (unconstrained) parameters as
    ``nn.Parameter``s (:func:`module_params`). Built from ``params`` or the
    spec's initial parameters (on ``cuda`` unless ``device`` is given)."""

    def __init__(self, spec, X: torch.Tensor, y: torch.Tensor, params: Params = None,
                 dtype=torch.float32, device=None):
        super().__init__()
        from vggp_tpu_torch import train

        if params is None:
            params = spec.init_params(dtype, device)
        raw = train.unconstrain(params)
        like = raw["noise"]
        self.spec = spec
        module_params(self, raw)
        self.register_buffer("X", X.to(dtype=like.dtype, device=like.device))
        self.register_buffer("y", y.reshape(-1).to(dtype=like.dtype, device=like.device))

    def raw_params(self) -> Params:
        """The nested raw tree, its leaves the module's parameters."""
        return module_raw_params(self)

    def params(self) -> Params:
        """The constrained parameter tree the model functions take."""
        from vggp_tpu_torch import train

        return train.constrain(self.raw_params())
