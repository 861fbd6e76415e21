"""The port's prior-path layer (``vggp_tpu_torch.sampling``) against the JAX
package's ``vggp_tpu/sampling.py``.

Given the same spectral draws (omegas, phases, amp and, for the coregion
forms, chol(B)) as numpy arrays, every inducing and grid functional, the
path evaluations and the mixed partials agree at rtol 1e-12 in float64 on
the CPU: cells on a uniform and a non-uniform mesh, points, VFF at Matérn-1/2,
3/2 and 5/2, B1, B2 and B3 splines, and the multi-output forms. The JAX side
of each test runs as one jitted program. The draws themselves, which take a
torch.Generator in place of a JAX key, are held by a KS test against scipy's
distributions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from vggp_tpu import features as jf
from vggp_tpu import sampling as jsampling
from vggp_tpu.models import sgpr as jsgpr

from vggp_tpu_torch import features as tf
from vggp_tpu_torch import sampling
from vggp_tpu_torch.models import common, sgpr
from vggp_tpu_torch.ops.chol import PSDFactor

RTOL = 1e-12
F = 64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for torch: the solvers' loops run thousands of
    small ops, which a thread pool contended by the other test workers
    slows many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())


def _t(a):
    return torch.as_tensor(np.array(a, dtype=np.float64))


def _stretched(m, a=0.0, b=1.0):
    s = np.linspace(0.0, 1.0, m + 1)
    return a + (b - a) * (s + 0.15 * np.sin(2 * np.pi * s) / (2 * np.pi))


# (name, JAX feature, port feature, kind): one axis each
_FEATURES = {
    "cells": lambda: (jf.CellIntegralFeature.from_lims(9, -0.1, 1.1),
                      tf.CellIntegralFeature.from_lims(9, -0.1, 1.1), "matern12"),
    "cells stretched": lambda: (jf.CellIntegralFeature(_stretched(11)),
                                tf.CellIntegralFeature(_stretched(11)), "matern32"),
    "points": lambda: (jf.PointFeature(m=7), tf.PointFeature(m=7), "matern52"),
    "vff 1/2": lambda: (jf.FourierFeature(n_frequencies=3, a=0.0, b=1.0),
                        tf.FourierFeature(n_frequencies=3, a=0.0, b=1.0), "matern12"),
    "vff 3/2": lambda: (jf.FourierFeature(n_frequencies=3, a=-0.2, b=1.0),
                        tf.FourierFeature(n_frequencies=3, a=-0.2, b=1.0), "matern32"),
    "vff 5/2": lambda: (jf.FourierFeature(n_frequencies=2, a=0.0, b=1.3),
                        tf.FourierFeature(n_frequencies=2, a=0.0, b=1.3), "matern52"),
    "b1": lambda: (jf.B1SplineFeature(mesh=np.linspace(0.0, 1.0, 7)),
                   tf.B1SplineFeature(mesh=np.linspace(0.0, 1.0, 7)), "matern12"),
    "b2": lambda: (jf.B2SplineFeature(5, 0.0, 1.0), tf.B2SplineFeature(5, 0.0, 1.0), "matern32"),
    "b3": lambda: (jf.B3SplineFeature(4, -0.1, 1.0), tf.B3SplineFeature(4, -0.1, 1.0),
                   "matern52"),
}


def _draws(d, seed, f=F, bundles=None):
    """Spectral draws as numpy arrays: omegas (d, F) (or (P, d, F)), phases,
    amp; the frequencies Cauchy-like heavy-tailed, a few near 0."""
    rng = np.random.default_rng(seed)
    shape = (d, f) if bundles is None else (bundles, d, f)
    om = rng.standard_t(2.0, size=shape) * 4.0
    om.reshape(-1)[:2] = (1e-14, -3e-4)      # the ω → 0 branches
    ph = rng.random(shape[:-2] + (f,)) * 2 * np.pi
    return om, ph, 0.37


def _axis_params(feat_name, i, jfeat):
    p = {"variance": 0.8 + 0.3 * i, "lengthscale": 0.21 + 0.07 * i}
    if feat_name == "points":
        p["z"] = np.linspace(-0.05, 1.02, jfeat.m) + 0.01 * i
    return p


def _spec_pair(names):
    built = [_FEATURES[n]() for n in names]
    kinds = tuple(k for _, _, k in built)
    jspec = jsgpr.SGPRSpec(kinds=kinds, features=tuple(j for j, _, _ in built))
    tspec = sgpr.SGPRSpec(kinds=kinds, features=tuple(t for _, t, _ in built))
    p_np = {"axes": tuple(_axis_params(n, i, built[i][0]) for i, n in enumerate(names)),
            "noise": 0.02}
    return jspec, tspec, p_np


def _jax_tree(tree):
    return jax.tree.map(lambda v: jnp.asarray(v, jnp.float64), tree)


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_torch_tree(v) for v in tree)
    return _t(tree)


@pytest.mark.parametrize("names", [("cells",), ("cells stretched",), ("points",),
                                   ("vff 1/2",), ("vff 3/2",), ("vff 5/2",), ("b1",), ("b2",),
                                   ("b3",), ("cells", "vff 3/2"), ("b1", "points", "b3")],
                         ids=lambda n: "+".join(n))
def test_prior_inducing_sample_matches_jax(names):
    """u_prior of every feature, alone and on product grids."""
    jspec, tspec, p_np = _spec_pair(names)
    om, ph, amp = _draws(len(names), seed=len(names) + 7 * len(names[0]))
    want = jax.jit(lambda o, h, p: jsampling.prior_inducing_sample(o, h, amp, jspec, p))(
        jnp.asarray(om), jnp.asarray(ph), _jax_tree(p_np))
    got = sampling.prior_inducing_sample(_t(om), _t(ph), _t(amp), tspec, _torch_tree(p_np))
    _close(got, want)


def _grids(stretched):
    if stretched:
        return ((jf.CellIntegralFeature(_stretched(6, -0.2, 0.9)),
                 jf.CellIntegralFeature.from_lims(4, 0.0, 1.0)),
                (tf.CellIntegralFeature(_stretched(6, -0.2, 0.9)),
                 tf.CellIntegralFeature.from_lims(4, 0.0, 1.0)))
    return ((jf.CellIntegralFeature.from_lims(5, 0.1, 0.9),
             jf.CellIntegralFeature.from_lims(3, -0.3, 1.2)),
            (tf.CellIntegralFeature.from_lims(5, 0.1, 0.9),
             tf.CellIntegralFeature.from_lims(3, -0.3, 1.2)))


@pytest.mark.parametrize("stretched", [False, True], ids=["uniform", "stretched"])
def test_grid_functionals_and_path_evaluations_match_jax(stretched):
    """v_prior (cell integrals), v'_prior on each axis (face differences),
    eval_path and eval_path_deriv at every order pattern."""
    jgrid, tgrid = _grids(stretched)
    om, ph, amp = _draws(2, seed=3)
    X = np.random.default_rng(4).random((13, 2))
    orders = ((1, 0), (0, 1), (1, 1), (2, 0), (2, 1))

    def jax_all(o, h, x):
        out = {"v": jsampling.prior_grid_integral_sample(o, h, amp, jgrid),
               "path": jsampling.eval_path(o, h, amp, x),
               "path 1-D": jsampling.eval_path(o[:1], h, amp, x[:, 0])}
        for a in (0, 1):
            out[f"v' {a}"] = jsampling.prior_grid_grad_sample(o, h, amp, jgrid, a)
        for od in orders:
            out[f"deriv {od}"] = jsampling.eval_path_deriv(o, h, amp, x, od)
        return out

    want = jax.jit(jax_all)(jnp.asarray(om), jnp.asarray(ph), jnp.asarray(X))
    o, h, x = _t(om), _t(ph), _t(X)
    got = {"v": sampling.prior_grid_integral_sample(o, h, _t(amp), tgrid),
           "path": sampling.eval_path(o, h, _t(amp), x),
           "path 1-D": sampling.eval_path(o[:1], h, _t(amp), x[:, 0])}
    for a in (0, 1):
        got[f"v' {a}"] = sampling.prior_grid_grad_sample(o, h, _t(amp), tgrid, a)
    for od in orders:
        got[f"deriv {od}"] = sampling.eval_path_deriv(o, h, _t(amp), x, od)
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k])


@pytest.mark.parametrize("co", [0, 1])
def test_multioutput_functionals_match_jax(co):
    """The coregion forms with the output axis first and last: the mixed
    inducing sample, grid integrals, face differences and path evaluation,
    from the same bundles and chol(B); and chol(B) itself from the
    parameters (``prior_paths_multioutput``)."""
    P = 3
    cells = ((jf.CellIntegralFeature.from_lims(6, 0.0, 1.0), jf.OutputFeature(n_outputs=P)),
             (tf.CellIntegralFeature.from_lims(6, 0.0, 1.0), tf.OutputFeature(n_outputs=P)))
    jf_, tf_ = (c if co == 1 else c[::-1] for c in cells)
    kinds = ("matern32", "coregion") if co == 1 else ("coregion", "matern32")
    jspec = jsgpr.SGPRSpec(kinds=kinds, features=jf_)
    tspec = sgpr.SGPRSpec(kinds=kinds, features=tf_)
    rng = np.random.default_rng(5)
    p_co = {"w": rng.standard_normal((P, 1)), "kappa": np.array([0.3, 0.5, 0.2])}
    p_ax = {"variance": 0.9, "lengthscale": 0.23}
    p_np = {"axes": (p_ax, p_co) if co == 1 else (p_co, p_ax), "noise": 0.02}
    om, ph, amp = _draws(1, seed=6, bundles=P)
    grid_j = (jf.CellIntegralFeature.from_lims(4, 0.1, 0.8), jf.OutputFeature(n_outputs=P))
    grid_t = (tf.CellIntegralFeature.from_lims(4, 0.1, 0.8), tf.OutputFeature(n_outputs=P))
    if co == 0:
        grid_j, grid_t = grid_j[::-1], grid_t[::-1]
    ax = 1 - co
    X = np.zeros((10, 2))
    X[:, ax] = rng.random(10)
    X[:, co] = rng.integers(0, P, 10)

    def jax_all(o, h, p, x):
        _, _, _, LB, c = jsampling.prior_paths_multioutput(jax.random.PRNGKey(0), jspec, p, 4)
        return {"LB": LB,
                "u": jsampling.prior_inducing_sample_multioutput(o, h, amp, LB, co, jspec, p),
                "v": jsampling.prior_grid_integral_sample_multioutput(o, h, amp, LB, co, grid_j),
                "v'": jsampling.prior_grid_grad_sample_multioutput(o, h, amp, LB, co, grid_j,
                                                                   ax),
                "path": jsampling.eval_path_multioutput(o, h, amp, LB, co, x)}

    want = jax.jit(jax_all)(jnp.asarray(om), jnp.asarray(ph), _jax_tree(p_np), jnp.asarray(X))
    p = _torch_tree(p_np)
    gen = torch.Generator().manual_seed(0)
    om_t, ph_t, amp_t, LB, c = sampling.prior_paths_multioutput(gen, tspec, p, 4)
    assert c == co and om_t.shape == (P, 1, 4) and ph_t.shape == (P, 4)
    o, h = _t(om), _t(ph)
    got = {"LB": LB,
           "u": sampling.prior_inducing_sample_multioutput(o, h, _t(amp), LB, co, tspec, p),
           "v": sampling.prior_grid_integral_sample_multioutput(o, h, _t(amp), LB, co, grid_t),
           "v'": sampling.prior_grid_grad_sample_multioutput(o, h, _t(amp), LB, co, grid_t, ax),
           "path": sampling.eval_path_multioutput(o, h, _t(amp), LB, co, _t(X))}
    for k in want:
        _close(got[k], want[k])
    with pytest.raises(ValueError, match="OutputFeature"):
        sampling.prior_grid_integral_sample_multioutput(
            o, h, _t(amp), LB, co, tuple(tf.CellIntegralFeature.from_lims(4, 0.0, 1.0)
                                         for _ in range(2)))
    with pytest.raises(ValueError, match="discrete output axis"):
        sampling.prior_grid_grad_sample_multioutput(o, h, _t(amp), LB, co, grid_t, co)
    with pytest.raises(NotImplementedError):
        sampling.prior_paths(gen, tspec, p, 4)


def test_whiten_axes_matches_jax():
    """The per-axis whitening solve along every axis of a tensor."""
    from vggp_tpu.ops.chol import PSDFactor as JaxPSDFactor

    rng = np.random.default_rng(8)
    w = rng.standard_normal((4, 5, 3))
    Ls = [np.linalg.cholesky(a @ a.T + n * np.eye(n))
          for n, a in ((k, rng.standard_normal((k, k))) for k in w.shape)]
    want = jsampling._whiten_axes(jnp.asarray(w), [JaxPSDFactor(jnp.asarray(L)) for L in Ls])
    got = sampling._whiten_axes(_t(w), [PSDFactor(_t(L)) for L in Ls])
    _close(got, want)


@pytest.mark.parametrize("kind", ["matern12", "matern32", "matern52", "rbf"])
def test_sample_frequencies_follow_the_spectral_density(kind):
    """20 000 draws from a fixed generator seed against scipy: a Student-t
    with df = 2ν and scale 1/ℓ for Matérn-ν, N(0, 1/ℓ²) for the RBF
    (KS p > 0.01, deterministic by the seed). The draws are the same in
    float32 and float64 up to the cast."""
    ell = 0.3
    gen = torch.Generator().manual_seed(11)
    om = sampling.sample_frequencies(gen, kind, torch.tensor(ell, dtype=torch.float64), 20_000)
    dist = (scipy.stats.norm(scale=1.0 / ell) if kind == "rbf" else
            scipy.stats.t(df={"matern12": 1, "matern32": 3, "matern52": 5}[kind],
                          scale=1.0 / ell))
    assert scipy.stats.kstest(om.numpy(), dist.cdf).pvalue > 0.01
    gen.manual_seed(11)
    om32 = sampling.sample_frequencies(gen, kind, torch.tensor(ell, dtype=torch.float32), 20_000)
    assert om32.dtype == torch.float32
    np.testing.assert_allclose(om32.numpy(), om.numpy(), rtol=1e-6)


def test_prior_paths_shapes_and_covariance():
    """prior_paths on a 2-D spec: shapes, amp = √(2σ²_total/F), and the
    empirical covariance of the path at two points against the product
    kernel (8000 paths of 256 features, 5 standard errors)."""
    spec = sgpr.SGPRSpec(kinds=("matern32", "rbf"), features=(
        tf.CellIntegralFeature.from_lims(4, 0.0, 1.0), tf.CellIntegralFeature.from_lims(4, 0.0, 1.0)))
    p = _torch_tree({"axes": ({"variance": 1.3, "lengthscale": 0.3},
                              {"variance": 0.7, "lengthscale": 0.5}), "noise": 0.1})
    gen = torch.Generator().manual_seed(2)
    om, ph, amp = sampling.prior_paths(gen, spec, p, 256)
    assert om.shape == (2, 256) and ph.shape == (256,)
    _close(amp, np.sqrt(2 * 1.3 * 0.7 / 256))
    X = _t([[0.2, 0.4], [0.35, 0.3]])
    vals = torch.stack([sampling.eval_path(*sampling.prior_paths(gen, spec, p, 256), X)
                        for _ in range(8000)])
    emp = (vals[:, 0] * vals[:, 1]).mean().item()
    want = common.gram_full(spec, p, X[:1], X[1:]).item()
    se = (vals[:, 0] * vals[:, 1]).std().item() / np.sqrt(8000)
    assert abs(emp - want) < 5 * se


def test_sample_gaussian_moments():
    """Joint draws from a materialized covariance and marginal draws from
    a variance: the empirical moments at 4000 draws."""
    from vggp_tpu_torch.models.common import Gaussian

    rng = np.random.default_rng(9)
    a = rng.standard_normal((4, 4))
    cov = a @ a.T + 0.5 * np.eye(4)
    mean = rng.standard_normal(4)
    gen = torch.Generator().manual_seed(3)
    s = sampling.sample_gaussian(gen, Gaussian(mean=_t(mean), cov=_t(cov)), 4000).numpy()
    np.testing.assert_allclose(s.mean(0), mean, atol=5 * np.sqrt(np.diag(cov).max() / 4000))
    np.testing.assert_allclose(np.cov(s.T), cov, atol=0.15 * np.abs(cov).max())
    s = sampling.sample_gaussian(gen, Gaussian(mean=_t(mean), var=_t(np.diag(cov))), 4000).numpy()
    np.testing.assert_allclose(s.var(0), np.diag(cov), rtol=0.1)
