"""High-level object API of the port (``vggp_tpu/api.py``): the reference's
class ergonomics over the functional core.

:class:`GP` is a thin, stateful facade over a collapsed or exact spec: it
owns ``(spec, params, data)`` and delegates 1:1 to ``models.sgpr`` /
``models.exact`` / ``train`` / ``sampling``; :class:`SVGP` does the same for
the minibatch SVGP and :class:`Streaming` for ``streaming``. No numerics
live here.

Each facade runs on one device and in one dtype: ``device=None`` is the card
(``config.resolve_device``: it raises when there is none; pass
``device="cpu"`` to run on the CPU), ``dtype`` float32 unless given. Params,
data and query points, numpy arrays or tensors, are moved to that device
and dtype. The JAX facade's jit caches have no counterpart; its state caches
do, with its rules for dropping them: the warm serving state ``SVGP._state``
and ``GP._w`` (the CG solve), ``GP._laplace`` (keyed by ``min_eig_rel``) and
``GP._hmc`` (keyed by the sampler's settings), dropped by ``fit`` and
``restore``. Where the JAX facade takes a key, this one takes a
``torch.Generator``; a ``seed`` argument seeds a generator on the facade's
device.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from vggp_tpu_torch import config, hyperpost, sampling, train
from vggp_tpu_torch import streaming as mstreaming
from vggp_tpu_torch.features import (
    B1SplineFeature,
    CellIntegralFeature,
    FourierFeature,
    OutputFeature,
    PointFeature,
    SplineRKHSFeature,
)
from vggp_tpu_torch.models import additive, exact, freesvgp, iterative, sgpr
from vggp_tpu_torch.models import sum as msum
from vggp_tpu_torch.models import svgp as msvgp
from vggp_tpu_torch.models.common import Gaussian

Lims = Tuple[float, float]


def _module_for(spec):
    """Functional-core module for a collapsed/exact spec (the GP facade)."""
    if isinstance(spec, exact.ExactGPSpec):
        return exact
    if isinstance(spec, sgpr.SGPRSpec):
        return sgpr
    if isinstance(spec, additive.AdditiveSGPRSpec):
        return additive
    if isinstance(spec, msum.SumSGPRSpec):
        return msum
    if isinstance(spec, freesvgp.FreeSVGPSpec):
        return freesvgp
    if isinstance(spec, msvgp.SVGPSpec):
        raise TypeError(
            "GP is the collapsed/exact facade; wrap an SVGPSpec in api.SVGP "
            "(minibatch trainer, data-free heads) instead"
        )
    raise TypeError(f"no facade dispatch for spec type {type(spec).__name__}")


def _lims_per_axis(lims, ndim: int) -> Tuple[Lims, ...]:
    """One (a, b) pair per axis; a single pair broadcasts to every axis."""
    if isinstance(lims[0], (tuple, list, np.ndarray)):
        pairs = tuple((float(a), float(b)) for a, b in lims)
    else:
        a, b = lims
        pairs = ((float(a), float(b)),) * ndim
    if len(pairs) != ndim:
        raise ValueError(f"expected {ndim} (a, b) lims pairs, got {len(pairs)}")
    return pairs


def _kinds(kinds: Union[str, Sequence[str]], ndim: int) -> Tuple[str, ...]:
    if isinstance(kinds, str):
        return (kinds,) * ndim
    kinds = tuple(kinds)
    if len(kinds) != ndim:
        raise ValueError(f"expected {ndim} kernel kinds, got {len(kinds)}")
    return kinds


def _infer_ndim(counts, lims, kinds, ndim: Optional[int]) -> int:
    """ndim from whichever argument is a sequence — counts, lims pairs, or
    kinds — never silently truncating a mismatch (zip would otherwise turn
    ``GP.gridded((6, 5), (0.0, 1.0))`` into a 1-D 6-cell model)."""
    if ndim is not None:
        return int(ndim)
    if isinstance(counts, (list, tuple, np.ndarray)):
        return len(counts)
    if isinstance(lims[0], (tuple, list, np.ndarray)):
        return len(lims)
    if not isinstance(kinds, str):
        return len(tuple(kinds))
    return 1


def _counts_per_axis(counts, ndim: int, name: str) -> Tuple[int, ...]:
    """One positive int per axis; a scalar broadcasts, a sequence must match."""
    if isinstance(counts, (list, tuple, np.ndarray)):
        out = tuple(int(c) for c in counts)
        if len(out) != ndim:
            raise ValueError(f"expected {ndim} {name} values, got {len(out)}")
    else:
        out = (int(counts),) * ndim
    if any(c <= 0 for c in out):
        raise ValueError(f"{name} must be positive, got {out}")
    return out


def _cells(n_cells, lims, kinds, ndim) -> Tuple[int, Tuple[CellIntegralFeature, ...]]:
    """(ndim, one B0 cell feature per axis) of a gridded factory."""
    ndim = _infer_ndim(n_cells, lims, kinds, ndim)
    lims_ax = _lims_per_axis(lims, ndim)
    cells = _counts_per_axis(n_cells, ndim, "n_cells")
    return ndim, tuple(CellIntegralFeature.from_lims(c, a, b)
                       for c, (a, b) in zip(cells, lims_ax))


class _Facade:
    """The device, dtype and input conversion the three facades share."""

    def __init__(self, device, dtype):
        self.device = config.resolve_device(device)
        self.dtype = dtype

    def _as(self, a) -> torch.Tensor:
        """A numpy array or tensor on the facade's device, in its dtype."""
        return torch.as_tensor(a, dtype=self.dtype, device=self.device)

    def _params(self, params: Dict) -> Dict:
        return train.tree_map(self._as, params)

    def _generator(self, seed: int) -> torch.Generator:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        return gen


class GP(_Facade):
    """Stateful facade over a collapsed (SGPR) or exact GP spec.

    Construct via a factory (:meth:`gridded`, :meth:`vff`, :meth:`asvgp`,
    :meth:`svgp`, :meth:`exact`) or pass any ``SGPRSpec`` / ``ExactGPSpec``
    directly. The reference classes these replace are cited on each factory.
    """

    def __init__(self, spec, params: Optional[Dict] = None, device=None,
                 dtype=torch.float32):
        super().__init__(device, dtype)
        self.spec = spec
        self._mod = _module_for(spec)
        self.params = (self._params(params) if params is not None
                       else spec.init_params(dtype, self.device))
        # user-supplied / restored / trained params survive fit()'s default
        # auto-initialisation
        self._params_are_fresh = params is None
        self.history: Optional[Dict] = None
        self._X = self._y = None
        self._w = None        # cached CG solve (solve_iterative)
        self._laplace = None  # cached (min_eig_rel, LaplaceState)
        self._hmc = None      # cached (settings key, HMCResult)

    # ------------------------------------------------------------------ #
    # Factories (one per reference model family)
    # ------------------------------------------------------------------ #

    @classmethod
    def gridded(cls, n_cells: Union[int, Sequence[int]], lims: Union[Lims, Sequence[Lims]],
                kinds: Union[str, Sequence[str]] = "matern12", ndim: Optional[int] = None,
                **facade_kwargs) -> "GP":
        """B0 cell-integral inducing features — the reference's ``GriddedGP`` /
        ``Matern12B0SplineGriddedGP`` zoo (``gridded_kronecker_structure.py:1255``).
        ``facade_kwargs`` (``device``, ``dtype``) go to the constructor, as
        in every factory."""
        ndim, feats = _cells(n_cells, lims, kinds, ndim)
        return cls(sgpr.SGPRSpec(kinds=_kinds(kinds, ndim), features=feats), **facade_kwargs)

    @classmethod
    def vff(cls, n_frequencies: Union[int, Sequence[int]], lims: Union[Lims, Sequence[Lims]],
            kinds: Union[str, Sequence[str]] = "matern12", ndim: Optional[int] = None,
            **facade_kwargs) -> "GP":
        """Variational Fourier features — the reference's ``VFFGP``
        (``univariate_structure.py:364``, Kronecker form at ``kronecker_structure.py``)."""
        ndim = _infer_ndim(n_frequencies, lims, kinds, ndim)
        lims_ax = _lims_per_axis(lims, ndim)
        nfreq = _counts_per_axis(n_frequencies, ndim, "n_frequencies")
        feats = tuple(FourierFeature(nf, a, b) for nf, (a, b) in zip(nfreq, lims_ax))
        return cls(sgpr.SGPRSpec(kinds=_kinds(kinds, ndim), features=feats), **facade_kwargs)

    @classmethod
    def asvgp(cls, n_knots: Union[int, Sequence[int]], lims: Union[Lims, Sequence[Lims]],
              kinds: Union[str, Sequence[str]] = "matern12", ndim: Optional[int] = None,
              **facade_kwargs) -> "GP":
        """Spline-RKHS features — the reference's ``ASVGP`` (B1 hats,
        ``univariate_structure.py:531``). Higher Matérn orders get the matching
        B2/B3 spline degree (beyond the reference's 1/2-only version)."""
        ndim = _infer_ndim(n_knots, lims, kinds, ndim)
        lims_ax = _lims_per_axis(lims, ndim)
        kds = _kinds(kinds, ndim)
        nk = _counts_per_axis(n_knots, ndim, "n_knots")
        feats = []
        for kind, k, (a, b) in zip(kds, nk, lims_ax):
            if kind == "matern12":
                feats.append(B1SplineFeature(np.linspace(a, b, k)))
            elif kind == "matern32":
                feats.append(SplineRKHSFeature(2, k - 2, a, b))
            elif kind == "matern52":
                feats.append(SplineRKHSFeature(3, k - 3, a, b))
            else:
                raise ValueError(f"no spline-RKHS pairing for kind {kind!r}")
        return cls(sgpr.SGPRSpec(kinds=kds, features=tuple(feats)), **facade_kwargs)

    @classmethod
    def svgp(cls, n_inducing: Union[int, Sequence[int]], lims: Union[Lims, Sequence[Lims]],
             kinds: Union[str, Sequence[str]] = "matern12", ndim: Optional[int] = None,
             **facade_kwargs) -> "GP":
        """Learnable inducing points on each axis — the reference's ``SVGP``
        (``univariate_structure.py:273``); z lives in the param tree."""
        ndim = _infer_ndim(n_inducing, lims, kinds, ndim)
        lims_ax = _lims_per_axis(lims, ndim)
        nz = _counts_per_axis(n_inducing, ndim, "n_inducing")
        feats = []
        for m, (a, b) in zip(nz, lims_ax):
            pad = 0.05 * (b - a)
            feats.append(PointFeature(m, np.linspace(a + pad, b - pad, m)))
        return cls(sgpr.SGPRSpec(kinds=_kinds(kinds, ndim), features=tuple(feats)),
                   **facade_kwargs)

    @classmethod
    def exact(cls, kinds: Union[str, Sequence[str]] = "matern12", ndim: int = 1,
              **facade_kwargs) -> "GP":
        """Dense exact GP (``exact/univariate_structure.py``, separable-product
        2D at ``bivariate_structure.py:144``)."""
        return cls(exact.ExactGPSpec(kinds=_kinds(kinds, ndim)), **facade_kwargs)

    @classmethod
    def additive(cls, n_cells: Union[int, Sequence[int]], lims: Union[Lims, Sequence[Lims]],
                 kinds: Union[str, Sequence[str]] = "matern12",
                 ndim: Optional[int] = None, **facade_kwargs) -> "GP":
        """Additive-structure GP f(x) = Σ_d f_d(x_d), one B0 cell-integral
        feature set per input axis (``models.additive``)."""
        ndim, feats = _cells(n_cells, lims, kinds, ndim)
        return cls(additive.AdditiveSGPRSpec(kinds=_kinds(kinds, ndim), features=feats),
                   **facade_kwargs)

    @classmethod
    def free_z(cls, n_inducing: int, lims: Union[Lims, Sequence[Lims]],
               kinds: Union[str, Sequence[str]] = "matern12",
               ndim: Optional[int] = None, seed: int = 0, **facade_kwargs) -> "GP":
        """FREE d-dimensional inducing points z_i ∈ ℝᵈ (Hadamard-product
        Grams) — the reference's nb61 Z-sweep model, ``models.freesvgp``.
        Unlike :meth:`svgp` (separable per-axis points), the m points do not
        factorize across axes; Z initializes uniformly at random in ``lims``
        from ``numpy.random.default_rng(seed)``. Grid heads
        (``q_v``/``q_dv``/``p_v_u``) need explicit ``grid_axes``.
        ``n_inducing`` is the TOTAL point count (not per-axis) — pass lims
        pairs or ``ndim`` for a multi-dimensional model."""
        ndim = _infer_ndim(None, lims, kinds, ndim)
        lims_ax = _lims_per_axis(lims, ndim)
        spec = freesvgp.FreeSVGPSpec(kinds=_kinds(kinds, ndim), m=int(n_inducing))
        lo = np.array([a for a, _ in lims_ax])
        hi = np.array([b for _, b in lims_ax])
        z0 = lo + (hi - lo) * np.random.default_rng(seed).random((int(n_inducing), ndim))
        gp = cls(spec, **facade_kwargs)
        gp.params = spec.init_params(gp.dtype, gp.device, z_init=z0)
        return gp

    @classmethod
    def sum(cls, components: Sequence, per_output_noise: bool = False,
            learn_mean: bool = False, **facade_kwargs) -> "GP":
        """Sum-of-kernels GP over shared axes (``models.sum``): each component
        is an ``SGPRSpec`` — or a :class:`GP` built by any factory above, whose
        spec is taken. Free per-component lengthscales are unidentifiable;
        freeze them via ``fit(trainable=...)`` (see ``models/sum.py``)."""
        specs = tuple(c.spec if isinstance(c, GP) else c for c in components)
        if not all(isinstance(s, sgpr.SGPRSpec) for s in specs):
            raise TypeError("sum components must be SGPRSpec (or GP over one)")
        return cls(msum.SumSGPRSpec(components=specs, per_output_noise=per_output_noise,
                                    learn_mean=learn_mean), **facade_kwargs)

    @classmethod
    def multioutput(cls, n_cells: Union[int, Sequence[int]], lims: Union[Lims, Sequence[Lims]],
                    n_outputs: int, kinds: Union[str, Sequence[str]] = "matern12",
                    ndim: Optional[int] = None, per_output_noise: bool = False,
                    learn_mean: bool = True, **facade_kwargs) -> "GP":
        """Multi-output ICM: gridded continuous axes plus one coregion axis
        (Kuu = B = WWᵀ + diag κ). The integer output index rides as the LAST
        column of X. ``learn_mean`` defaults on: a zero-mean GP absorbs
        inter-output offsets into κ, deflating the learned correlation."""
        ndim, feats = _cells(n_cells, lims, kinds, ndim)
        return cls(sgpr.SGPRSpec(
            kinds=_kinds(kinds, ndim) + ("coregion",),
            features=feats + (OutputFeature(n_outputs=int(n_outputs)),),
            per_output_noise=per_output_noise, learn_mean=learn_mean), **facade_kwargs)

    # ------------------------------------------------------------------ #
    # Training
    # ------------------------------------------------------------------ #

    def _params_changed(self) -> None:
        self._w = None
        self._laplace = None
        self._hmc = None

    def non_informative_initialise(self, X, y, lmbda: float = 1.0, kappa: float = 2.0) -> "GP":
        """Reference ``non_informative_initialise`` (``univariate_structure.py:86``)."""
        self.params = train.non_informative_init(self.params, self._as(X), self._as(y),
                                                 lmbda=lmbda, kappa=kappa)
        self._params_changed()
        return self

    def fit(self, X, y, n_iters: int = 1000, learning_rate: float = 0.1,
            initialise: Optional[bool] = None, **fit_kwargs) -> "GP":
        """Full-batch Adam fit of the collapsed bound / exact MLL
        (``train.fit``); stores the data so every prediction head below
        needs no further arguments.

        ``initialise=None`` (default) runs ``non_informative_initialise``
        only on fresh ``spec.init_params()`` params — explicitly supplied,
        restored, or already-trained params are kept (continued training);
        pass ``True``/``False`` to force either way.
        """
        self._X, self._y = self._as(X), self._as(y)
        if initialise is None:
            initialise = self._params_are_fresh
        if initialise:
            self.non_informative_initialise(self._X, self._y)
        self._params_are_fresh = False
        spec, X, y = self.spec, self._X, self._y
        self.params, self.history = train.fit(
            lambda p: self._mod.loss(spec, p, X, y), self.params, n_iters, learning_rate,
            **fit_kwargs)
        self._params_changed()
        return self

    @torch.no_grad()
    def elbo(self) -> float:
        """Collapsed ELBO (exact GP: log marginal likelihood)."""
        self._need_data()
        return float(-self._mod.loss(self.spec, self.params, self._X, self._y))

    # ------------------------------------------------------------------ #
    # Prediction heads
    # ------------------------------------------------------------------ #

    @torch.no_grad()
    def predict(self, xstar, full_cov: bool = False, predictive: bool = False) -> Gaussian:
        """Posterior q(f*) (``predictive=True`` adds observation noise)."""
        self._need_data()
        head = self._mod.posterior_predictive if predictive else self._mod.posterior
        return head(self.spec, self.params, self._X, self._y, self._as(xstar),
                    full_cov=full_cov)

    @torch.no_grad()
    def q_v(self, grid_axes=None, full_cov: bool = False) -> Gaussian:
        """Gridded product: posterior over cell integrals (the headline output).

        ``grid_axes`` defaults to the model's own cell features (the
        reference's *direct* GriddedGP, where q(v) == q(u))."""
        self._need_data()
        return self._mod.q_v(self.spec, self.params, self._X, self._y,
                             self._grid_axes(grid_axes), full_cov=full_cov)

    @torch.no_grad()
    def q_dv(self, grid_axes=None, axis: int = 0, full_cov: bool = False) -> Gaussian:
        """Gridded-gradient product along ``axis`` (face differences)."""
        self._need_data()
        return self._mod.q_dv(self.spec, self.params, self._X, self._y,
                              self._grid_axes(grid_axes), axis=axis, full_cov=full_cov)

    @torch.no_grad()
    def posterior_grad(self, xstar, axis: int = 0, full_cov: bool = False) -> Gaussian:
        """Pointwise-gradient posterior ∂f/∂x_axis (needs a once-differentiable
        kernel on ``axis`` — Matérn ≥ 3/2 or RBF, not matern12)."""
        self._need_data()
        return self._mod.posterior_grad(self.spec, self.params, self._X, self._y,
                                        self._as(xstar), axis=axis, full_cov=full_cov)

    @torch.no_grad()
    def q_u(self) -> Gaussian:
        """Optimal q(u) of the collapsed bound (undefined for exact GPs)."""
        self._need_data()
        if self._mod is exact:
            raise ValueError("exact GPs have no inducing variables u")
        return self._mod.q_u(self.spec, self.params, self._X, self._y)

    @torch.no_grad()
    def p_v_u(self, grid_axes=None) -> Gaussian:
        """p(v | u = E_q[u]) over the grid (undefined for exact GPs)."""
        self._need_data()
        if self._mod is exact:
            raise ValueError("exact GPs have no inducing variables u")
        return self._mod.p_v_u(self.spec, self.params, self._X, self._y,
                               self._grid_axes(grid_axes))

    @torch.no_grad()
    def sample(self, gen: torch.Generator, xstar, n_samples: int = 8,
               n_features: int = 1024) -> torch.Tensor:
        """Coherent pathwise posterior draws at xstar (Matheron's rule)."""
        self._need_data()
        return sampling.pathwise(self.spec, self.params, gen, self._as(xstar),
                                 data=(self._X, self._y),
                                 n_samples=n_samples, n_features=n_features)

    @torch.no_grad()
    def sample_q_v(self, gen: torch.Generator, grid_axes=None, n_samples: int = 8,
                   n_features: int = 1024) -> torch.Tensor:
        """Joint draws of the gridded product itself (exact integral
        functionals), a learned mean's cell integrals included."""
        self._need_data()
        return sampling.pathwise_q_v(self.spec, self.params, gen, self._grid_axes(grid_axes),
                                     n_samples=n_samples, n_features=n_features,
                                     data=(self._X, self._y))

    # ------------------------------------------------------------------ #
    # Matrix-free (CG) mean heads — very large inducing grids
    # ------------------------------------------------------------------ #

    def solve_iterative(self, tol: Optional[float] = None, maxiter: int = 1000) -> "GP":
        """Run the preconditioned CG solve (``models.iterative``) and cache
        w = (σ²Kuu + KufKufᵀ)⁻¹Kuf y for the mean heads below. Any number of
        Kronecker axes (continuous kinds), no (m, m) factorization, so
        m ≈ 10⁴–10⁵ inducing cells is fine where dense :meth:`q_v` is not.
        Invalidated by ``fit``/``restore`` (w is a function of the params)."""
        self._need_data()
        self._w = iterative.solve_w(self.spec, self.params, self._X, self._y, tol=tol,
                                    maxiter=maxiter)
        return self

    def _solved_w(self) -> torch.Tensor:
        if self._w is None:
            self.solve_iterative()
        return self._w

    @torch.no_grad()
    def predict_mean_iterative(self, xstar) -> torch.Tensor:
        """E_q[f*] via the cached CG solve (== ``predict(...).mean``);
        runs :meth:`solve_iterative` with defaults if not yet solved."""
        w = self._solved_w()
        return iterative.posterior_mean_from_w(self.spec, self.params, self._as(xstar), w)

    @torch.no_grad()
    def q_v_mean_iterative(self, grid_axes=None) -> torch.Tensor:
        """E_q[v] (gridded-product mean field) via the cached CG solve
        (== ``q_v(...).mean``); for matching matrix-free uncertainties see
        :meth:`q_v_pathwise_iterative`."""
        w = self._solved_w()
        return iterative.q_v_mean_from_w(self.spec, self.params, self._grid_axes(grid_axes), w)

    @torch.no_grad()
    def q_dv_mean_iterative(self, grid_axes=None, axis: int = 0) -> torch.Tensor:
        """Gridded-GRADIENT product mean ∫_cell ∂f/∂x_axis via the cached CG
        solve (== ``q_dv(...).mean``); valid for every kind incl. matern12."""
        w = self._solved_w()
        return iterative.q_dv_mean_from_w(self.spec, self.params, self._grid_axes(grid_axes),
                                          axis, w)

    @torch.no_grad()
    def predict_grad_mean_iterative(self, xstar, axis: int = 0) -> torch.Tensor:
        """Pointwise-gradient posterior mean ∂f/∂x_axis via the cached CG
        solve (== ``posterior_grad(...).mean``); needs a once-differentiable
        kernel on ``axis``."""
        w = self._solved_w()
        return iterative.posterior_grad_mean_from_w(self.spec, self.params, self._as(xstar),
                                                    axis, w)

    @torch.no_grad()
    def q_v_pathwise_iterative(self, grid_axes=None, n_samples: int = 64,
                               n_features: int = 1024, seed: int = 0,
                               **cg_kwargs) -> Gaussian:
        """Matrix-free gridded product WITH per-cell uncertainty: Matheron
        posterior draws through CG solves (``iterative.q_v_pathwise``) —
        exact moments up to MC error ~√(2/S), no (m, m) factorization."""
        self._need_data()
        return iterative.q_v_pathwise(self.spec, self.params, self._X, self._y,
                                      self._grid_axes(grid_axes), self._generator(seed),
                                      n_samples=n_samples, n_features=n_features, **cg_kwargs)

    @torch.no_grad()
    def q_dv_pathwise_iterative(self, grid_axes=None, axis: int = 0,
                                n_samples: int = 64, n_features: int = 1024,
                                seed: int = 0, **cg_kwargs) -> Gaussian:
        """Matrix-free gridded-GRADIENT product WITH per-cell uncertainty
        (face-difference Matheron draws through CG solves)."""
        self._need_data()
        return iterative.q_dv_pathwise(self.spec, self.params, self._X, self._y,
                                       self._grid_axes(grid_axes), axis, self._generator(seed),
                                       n_samples=n_samples, n_features=n_features, **cg_kwargs)

    # ------------------------------------------------------------------ #
    # Hyperparameter-posterior (Laplace) marginalized prediction
    # ------------------------------------------------------------------ #

    def laplace(self, min_eig_rel: float = 1e-8):
        """Laplace approximation N(θ̂, H⁻¹) to the hyperparameter posterior
        at the current (fitted) params (``hyperpost.laplace``), over the same
        collapsed bound / MLL ``fit`` minimized. Cached until the params
        change OR ``min_eig_rel`` differs from the cached build's.

        The Hessian goes through ``models.common.second_order()``, so it is
        taken for every family, the ones that whiten through the dense
        factor (point features, free points, sums) included: there the JAX
        facade's ``laplace`` raises, since ``jax.hessian`` cannot
        differentiate its ``custom_vjp`` whitening twice."""
        self._need_data()
        if self._laplace is None or self._laplace[0] != min_eig_rel:
            spec, X, y = self.spec, self._X, self._y
            self._laplace = (min_eig_rel, hyperpost.laplace(
                lambda p: self._mod.loss(spec, p, X, y), self.params,
                min_eig_rel=min_eig_rel))
        return self._laplace[1]

    def hmc(self, n_samples: int = 256, n_chains: int = 4,
            n_warmup: int = 128, seed: int = 0, **hmc_kwargs):
        """Full-MCMC hyperparameter draws (``hyperpost.hmc_sample_params``) —
        the exact check on :meth:`laplace`'s Gaussian (which preconditions
        the sampler). Returns an ``HMCResult``; cached until the params
        change or the sampler settings differ."""
        self._need_data()
        key = (n_samples, n_chains, n_warmup, seed, tuple(sorted(hmc_kwargs.items())))
        if self._hmc is None or self._hmc[0] != key:
            state = self.laplace()
            spec, X, y = self.spec, self._X, self._y
            self._hmc = (key, hyperpost.hmc_sample_params(
                lambda p: self._mod.loss(spec, p, X, y), state, self._generator(seed),
                n_samples=n_samples, n_chains=n_chains, n_warmup=n_warmup, **hmc_kwargs))
        return self._hmc[1]

    def _marginal_draws(self, method: str, n_samples: int, seed: int):
        """Hyperparameter draws for the marginalized heads: n_samples fresh
        Gaussian draws from the Laplace state, or an even thinning of the
        (cached) HMC chain."""
        if method == "laplace":
            return hyperpost.sample_params(self.laplace(), self._generator(seed), n_samples)
        if method == "hmc":
            res = self.hmc(n_samples=max(n_samples, 256), seed=seed)
            total = train.tree_leaves(res.draws)[0].shape[0]
            idx = torch.as_tensor(np.linspace(0, total - 1, min(n_samples, total)).astype(np.int64),
                                  device=self.device)
            return train.tree_map(lambda a: a[idx], res.draws)
        raise ValueError(f"method must be 'laplace' or 'hmc', got {method!r}")

    def predict_marginalized(self, xstar, n_samples: int = 64, seed: int = 0,
                             method: str = "laplace") -> Gaussian:
        """q(f*) with hyperparameter uncertainty: the posterior head over
        hyperparameter draws, moment-matched (law of total variance).
        ``method="laplace"`` (default) draws from the Gaussian Laplace
        state; ``method="hmc"`` thins the full-MCMC chain (:meth:`hmc`)
        (``hyperpost.predict_marginalized_draws``)."""
        self._need_data()
        draws = self._marginal_draws(method, n_samples, seed)
        spec, X, y, xs = self.spec, self._X, self._y, self._as(xstar)
        with torch.no_grad():
            return hyperpost.predict_marginalized_draws(
                lambda p: self._mod.posterior(spec, p, X, y, xs, full_cov=False), draws)

    def q_v_marginalized(self, grid_axes=None, n_samples: int = 64,
                         seed: int = 0, method: str = "laplace") -> Gaussian:
        """Gridded product q(v) marginalized over the hyperparameter
        posterior (moment-matched mixture of per-draw q_v marginals);
        ``method`` as in :meth:`predict_marginalized`."""
        self._need_data()
        draws = self._marginal_draws(method, n_samples, seed)
        axes = self._grid_axes(grid_axes)
        spec, X, y = self.spec, self._X, self._y
        with torch.no_grad():
            return hyperpost.predict_marginalized_draws(
                lambda p: self._mod.q_v(spec, p, X, y, axes, full_cov=False), draws)

    # ------------------------------------------------------------------ #
    # Persistence
    # ------------------------------------------------------------------ #

    def save(self, path: str, step: int = 0) -> None:
        """Checkpoint the (constrained) params (``train.save_checkpoint``);
        the spec is static Python — rebuild it from code and :meth:`restore`."""
        train.save_checkpoint(path, self.params, step=step)

    def restore(self, path: str, step: int = 0) -> "GP":
        """Load params saved by :meth:`save` onto the facade's device."""
        self.params = self._params(train.load_checkpoint(path, step=step, like=self.params,
                                                         map_location=self.device))
        self._params_are_fresh = False  # continued training keeps the restore
        self._params_changed()
        return self

    # ------------------------------------------------------------------ #

    def _grid_axes(self, grid_axes) -> tuple:
        if grid_axes is None:
            feats = getattr(self.spec, "features", None)
            if feats is None:
                comps = getattr(self.spec, "components", None)
                if comps is None:  # free-Z: no per-axis features to default to
                    raise ValueError(
                        "this spec has no per-axis grid features (free "
                        "inducing points); pass grid_axes explicitly")
                feats = comps[0].features  # sum-of-kernels: shared axes
            if not all(isinstance(f, (CellIntegralFeature, OutputFeature)) for f in feats):
                raise ValueError("grid_axes is required unless every model axis "
                                 "is a CellIntegralFeature (direct GriddedGP) "
                                 "or the coregion OutputFeature")
            return tuple(feats)
        if isinstance(grid_axes, CellIntegralFeature):
            return (grid_axes,)
        return tuple(grid_axes)

    def _need_data(self) -> None:
        if self._X is None:
            raise ValueError("call .fit(X, y) first (the collapsed/exact "
                             "posterior is a function of the training data)")


class SVGP(_Facade):
    """Stateful facade over the uncollapsed minibatch SVGP (``models.svgp``).

    The scalable flagship path: whitened variational family
    (``variational="kron"`` Kronecker-factored covariance scales to 512²+
    inducing grids on one card), stochastic ``fit`` over minibatches, hybrid
    natural-gradient ``fit_natgrad``, non-Gaussian likelihoods via
    ``spec.likelihood``. Unlike :class:`GP`, the posterior lives entirely in
    the variational parameters, so every prediction head is data-free.
    """

    def __init__(self, spec: msvgp.SVGPSpec, params: Optional[Dict] = None, device=None,
                 dtype=torch.float32):
        if not isinstance(spec, msvgp.SVGPSpec):
            raise TypeError(f"SVGP facade needs an SVGPSpec, got {type(spec).__name__}")
        super().__init__(device, dtype)
        self.spec = spec
        self.params = (self._params(params) if params is not None
                       else spec.init_params(dtype, self.device))
        self._params_are_fresh = params is None
        self.history: Optional[Dict] = None
        self._state = None  # warm serving cache (see precompute())

    # ------------------------------------------------------------------ #
    # Factories
    # ------------------------------------------------------------------ #

    @classmethod
    def gridded(cls, n_cells: Union[int, Sequence[int]], lims: Union[Lims, Sequence[Lims]],
                num_data: int, kinds: Union[str, Sequence[str]] = "matern12",
                variational: Optional[str] = None, likelihood: str = "gaussian",
                ndim: Optional[int] = None, learn_mean: bool = False,
                device=None, dtype=torch.float32, **spec_kwargs) -> "SVGP":
        """B0 cell-integral inducing grid, minibatch-trainable. ``variational``
        defaults to the Kronecker-factored family for ndim ≥ 2 (the 512²-grid
        main path) and the full family for 1D."""
        ndim, feats = _cells(n_cells, lims, kinds, ndim)
        if variational is None:
            variational = "kron" if ndim >= 2 else "full"
        return cls(msvgp.SVGPSpec(kinds=_kinds(kinds, ndim), features=feats,
                                  num_data=int(num_data), variational=variational,
                                  likelihood=likelihood, learn_mean=learn_mean,
                                  **spec_kwargs), device=device, dtype=dtype)

    @classmethod
    def multioutput(cls, n_cells: Union[int, Sequence[int]], lims: Union[Lims, Sequence[Lims]],
                    n_outputs: int, num_data: int,
                    kinds: Union[str, Sequence[str]] = "matern12",
                    ndim: Optional[int] = None, per_output_noise: bool = False,
                    learn_mean: bool = True, variational: str = "kron",
                    device=None, dtype=torch.float32, **spec_kwargs) -> "SVGP":
        """Multi-output ICM SVGP: continuous cell axes + a coregion axis; the
        output index is the LAST column of X. ``variational`` defaults to the
        Kronecker family; pass ``"full"`` for a natgrad-trainable / streamable
        model. Prefer collapsed :meth:`GP.multioutput` at small n."""
        ndim, feats = _cells(n_cells, lims, kinds, ndim)
        return cls(msvgp.SVGPSpec(
            kinds=_kinds(kinds, ndim) + ("coregion",),
            features=feats + (OutputFeature(n_outputs=int(n_outputs)),),
            num_data=int(num_data), variational=variational,
            per_output_noise=per_output_noise, learn_mean=learn_mean,
            **spec_kwargs), device=device, dtype=dtype)

    # ------------------------------------------------------------------ #
    # Training
    # ------------------------------------------------------------------ #

    def non_informative_initialise(self, X, y, lmbda: float = 1.0, kappa: float = 2.0) -> "SVGP":
        self.params = train.non_informative_init(self.params, self._as(X), self._as(y),
                                                 lmbda=lmbda, kappa=kappa)
        self._state = None  # params changed; warm cache is stale
        return self

    def _init_data(self, X, y, initialise: Optional[bool]):
        X, y = self._as(X), self._as(y)
        if initialise is None:
            initialise = self._params_are_fresh
        if initialise:
            self.non_informative_initialise(X, y)
        self._params_are_fresh = False
        return X, y

    def fit(self, X, y, n_iters: int = 1000, batch_size: int = 4096,
            learning_rate: float = 0.01, seed: int = 0,
            initialise: Optional[bool] = None) -> "SVGP":
        """Stochastic ELBO fit: ``train.fit_minibatch`` (uniform minibatches
        from a generator seeded with ``seed`` on the facade's device). Fresh
        params are non-informatively initialised; supplied/restored/trained
        params are kept (pass ``initialise=True/False`` to force)."""
        X, y = self._init_data(X, y, initialise)
        spec = self.spec
        self.params, self.history = train.fit_minibatch(
            lambda p, xb, yb: msvgp.loss(spec, p, xb, yb),
            self.params, X, y, n_iters, min(int(batch_size), y.shape[0]),
            learning_rate, seed=seed)
        self._state = None
        return self

    def fit_natgrad(self, X, y, n_iters: int = 200, gamma: float = 0.5,
                    hyper_lr: float = 0.01, batch_size: Optional[int] = None,
                    seed: int = 0, initialise: Optional[bool] = None) -> "SVGP":
        """Hybrid trainer: natural-gradient steps on q, Adam on the hypers
        (``train.fit_natgrad``; full variational family only)."""
        X, y = self._init_data(X, y, initialise)
        self.params, self.history = train.fit_natgrad(
            self.spec, self.params, X, y, n_iters, gamma=gamma,
            hyper_lr=hyper_lr, batch_size=batch_size, seed=seed)
        self._state = None
        return self

    @torch.no_grad()
    def elbo(self, X, y) -> float:
        """Full-dataset ELBO at the current params."""
        return float(msvgp.elbo(self.spec, self.params, self._as(X), self._as(y)))

    # ------------------------------------------------------------------ #
    # Prediction heads (data-free: the posterior lives in q)
    # ------------------------------------------------------------------ #

    @torch.no_grad()
    def precompute(self) -> "SVGP":
        """Build the frozen-param serving cache (``models.svgp.precompute``):
        per-axis Kuu factorizations + the variational Cholesky, computed once.
        Until the params change (``fit``/``restore`` invalidate it), every
        ``predict`` / ``q_v`` / ``q_dv`` / ``posterior_grad`` call rides the
        warm ``*_from_state`` heads — query-size work only."""
        self._state = msvgp.precompute(self.spec, self.params)
        return self

    @torch.no_grad()
    def predict(self, xstar, full_cov: bool = False, predictive: bool = False) -> Gaussian:
        xs = self._as(xstar)
        if self._state is not None:
            return msvgp.posterior_from_state(self.spec, self.params, self._state, xs,
                                              full_cov=full_cov, predictive=predictive)
        return msvgp.posterior(self.spec, self.params, xs, full_cov=full_cov,
                               predictive=predictive)

    @torch.no_grad()
    def predict_y(self, xstar):
        """Observable-space prediction under the spec's likelihood (probit
        class probability, Poisson rate, Student-t predictive, …)."""
        return msvgp.predict_y(self.spec, self.params, self._as(xstar))

    @torch.no_grad()
    def prior(self, xstar) -> Gaussian:
        return msvgp.prior(self.spec, self.params, self._as(xstar))

    @torch.no_grad()
    def q_u(self) -> Gaussian:
        return msvgp.q_u(self.spec, self.params)

    @torch.no_grad()
    def p_v_u(self, grid_axes=None) -> Gaussian:
        return msvgp.p_v_u(self.spec, self.params, self._grid_axes(grid_axes))

    @torch.no_grad()
    def q_v(self, grid_axes=None, full_cov: bool = False) -> Gaussian:
        """Gridded product q(v) straight from the variational state (the
        serving path)."""
        axes = self._grid_axes(grid_axes)
        if self._state is not None:
            return msvgp.q_v_from_state(self.spec, self.params, self._state, axes,
                                        full_cov=full_cov)
        return msvgp.q_v(self.spec, self.params, axes, full_cov=full_cov)

    @torch.no_grad()
    def q_dv(self, grid_axes=None, axis: int = 0, full_cov: bool = False) -> Gaussian:
        axes = self._grid_axes(grid_axes)
        if self._state is not None:
            return msvgp.q_dv_from_state(self.spec, self.params, self._state, axes,
                                         axis=axis, full_cov=full_cov)
        return msvgp.q_dv(self.spec, self.params, axes, axis=axis, full_cov=full_cov)

    @torch.no_grad()
    def posterior_grad(self, xstar, axis: int = 0, full_cov: bool = False) -> Gaussian:
        xs = self._as(xstar)
        if self._state is not None:
            return msvgp.posterior_grad_from_state(self.spec, self.params, self._state, xs,
                                                   axis=axis, full_cov=full_cov)
        return msvgp.posterior_grad(self.spec, self.params, xs, axis=axis, full_cov=full_cov)

    @torch.no_grad()
    def sample(self, gen: torch.Generator, xstar, n_samples: int = 8,
               n_features: int = 1024) -> torch.Tensor:
        return sampling.pathwise(self.spec, self.params, gen, self._as(xstar),
                                 n_samples=n_samples, n_features=n_features)

    @torch.no_grad()
    def sample_q_v(self, gen: torch.Generator, grid_axes=None, n_samples: int = 8,
                   n_features: int = 1024) -> torch.Tensor:
        """Joint draws of the gridded product, a learned mean's cell
        integrals included."""
        return sampling.pathwise_q_v(self.spec, self.params, gen, self._grid_axes(grid_axes),
                                     n_samples=n_samples, n_features=n_features)

    # ------------------------------------------------------------------ #

    def streaming(self, dtype=None) -> "Streaming":
        """Open an online-assimilation stream at the current hyperparameters
        (``vggp_tpu_torch.streaming``; full variational family only) on the
        facade's device."""
        return Streaming(self.spec, self.params, dtype=dtype, device=self.device)

    def save(self, path: str, step: int = 0) -> None:
        train.save_checkpoint(path, self.params, step=step)

    def restore(self, path: str, step: int = 0) -> "SVGP":
        """Load params saved by :meth:`save` onto the facade's device."""
        self.params = self._params(train.load_checkpoint(path, step=step, like=self.params,
                                                         map_location=self.device))
        self._params_are_fresh = False
        self._state = None
        return self

    def _grid_axes(self, grid_axes) -> tuple:
        return GP._grid_axes(self, grid_axes)


class Streaming:
    """Stateful facade over :mod:`vggp_tpu_torch.streaming` — exact online
    assimilation of the whitened SVGP posterior (natural-parameter RLS).

    Hyperparameters are FIXED while assimilating (that is the exactness
    contract); drift is handled by :meth:`reanchor`. Conjugate (Gaussian)
    batches use the closed-form update; non-conjugate specs route through
    the CVI site update automatically. The params keep their dtype; the
    stream state takes ``dtype`` (the params' when None). Runs on ``device``
    (the card unless given).
    """

    def __init__(self, spec: msvgp.SVGPSpec, params: Dict, dtype=None, device=None):
        self.device = config.resolve_device(device)
        self.spec = spec
        self.params = self._params(params)
        dtype = dtype or self.params["noise"].dtype
        self.state = mstreaming.init_state(spec, dtype, self.device)

    def _as(self, a) -> torch.Tensor:
        """Data in the params' dtype, on the stream's device."""
        return torch.as_tensor(a, dtype=self.params["noise"].dtype, device=self.device)

    def _params(self, params: Dict) -> Dict:
        return train.tree_map(lambda v: torch.as_tensor(v, device=self.device), params)

    @property
    def n_seen(self) -> float:
        return float(self.state["n_seen"])

    @torch.no_grad()
    def assimilate(self, X, y, noise=None, gamma: float = 0.5) -> "Streaming":
        """Fold one batch in. Gaussian likelihood → exact closed-form update
        (chunk/order independent); non-conjugate → damped CVI site update."""
        X, y = self._as(X), self._as(y)
        if self.spec.likelihood == "gaussian":
            nb = None if noise is None else self._as(noise)
            self.state = mstreaming.assimilate(self.spec, self.params, self.state, X, y,
                                               noise=nb)
        else:
            if noise is not None:
                raise ValueError(
                    "per-point noise is a Gaussian-likelihood concept; the "
                    "CVI site update for a non-conjugate spec takes no noise "
                    "argument (it would be silently ignored)")
            self.state = mstreaming.assimilate_natgrad(self.spec, self.params, self.state, X, y,
                                                       gamma=gamma)
        return self

    def forget(self, rho: float) -> "Streaming":
        """Exponentially discount past data toward the prior (Λ ⪰ I kept)."""
        self.state = mstreaming.forget(self.state, rho)
        return self

    @torch.no_grad()
    def reanchor(self, params_new: Dict) -> "Streaming":
        """Transfer the stream state to new hyperparameters (online drift:
        refit hypers on a window, reanchor, keep assimilating)."""
        params_new = self._params(params_new)
        self.state = mstreaming.reanchor(self.spec, self.params, params_new, self.state)
        self.params = params_new
        return self

    def _q_params(self) -> Dict:
        """The streamed q(w) written into SVGP params (``streaming.to_params``),
        every leaf in the stream state's dtype."""
        dtype = self.state["lam"].dtype
        return train.tree_map(lambda v: v.to(dtype),
                              mstreaming.to_params(self.spec, self.params, self.state))

    @torch.no_grad()
    def to_svgp(self) -> SVGP:
        """Materialize the streamed q(w) into SVGP params, in the stream
        state's dtype: every head (predict / q_v / sample) then works as if
        that q had been trained."""
        return SVGP(self.spec, params=self._q_params(), device=self.device,
                    dtype=self.state["lam"].dtype)

    # convenience heads (delegate through the materialized params)
    @torch.no_grad()
    def predict(self, xstar, full_cov: bool = False, predictive: bool = False) -> Gaussian:
        q = self._q_params()
        xs = torch.as_tensor(xstar, dtype=q["noise"].dtype, device=self.device)
        return msvgp.posterior(self.spec, q, xs, full_cov=full_cov, predictive=predictive)

    @torch.no_grad()
    def q_v(self, grid_axes, full_cov: bool = False) -> Gaussian:
        axes = (grid_axes,) if isinstance(grid_axes, CellIntegralFeature) else tuple(grid_axes)
        return msvgp.q_v(self.spec, self._q_params(), axes, full_cov=full_cov)
