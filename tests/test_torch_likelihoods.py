"""The port's observation models (``vggp_tpu_torch.likelihoods``) against the
JAX package: each expected log-likelihood and predictive transform, the
Kronecker SVGP's loss and every gradient leaf under each likelihood, and its
``predict_y``; and ``sample_observations`` by its moments (its draws come
from a ``torch.Generator``, so they cannot match JAX's bit for bit).

Same numpy inputs, float64 on the CPU. Elementwise functions at rtol 1e-12,
the SVGP loss at 1e-10 and its gradients at 1e-7 (as the Gaussian SVGP's).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vggp_tpu import likelihoods as jlik
from vggp_tpu import train as jtrain
from vggp_tpu.features import CellIntegralFeature as JaxCellFeature
from vggp_tpu.models import svgp as jsvgp

from vggp_tpu_torch import convert, likelihoods, train
from vggp_tpu_torch.features import CellIntegralFeature
from vggp_tpu_torch.models import svgp

LIKELIHOODS = [("gaussian", ()), ("bernoulli", ()), ("poisson", ()),
               ("student_t", (("df", 4.0),)), ("student_t", (("df", 2.5),))]
_IDS = ["gaussian", "bernoulli", "poisson", "student_t-4", "student_t-2.5"]


def _targets(name, f, rng):
    """Observations of each kind around latent values ``f``."""
    if name == "bernoulli":
        return (f + 0.3 * rng.standard_normal(f.shape) > 0).astype(float)
    if name == "poisson":
        return rng.poisson(np.exp(f)).astype(float)
    return f + 0.2 * rng.standard_normal(f.shape)


def _close(got, want, rtol):
    got, want = got.detach().numpy(), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("name,opts", LIKELIHOODS, ids=_IDS)
def test_expected_log_lik_matches_jax(name, opts):
    """ℓ_i and its gradients in (μ, σ², noise), rtol 1e-12 (the same 64
    Gauss–Hermite nodes and weights)."""
    rng = np.random.default_rng(0)
    n = 300
    mean, var = rng.standard_normal(n), 0.05 + 2.0 * rng.random(n)
    y = _targets(name, mean, rng)
    noise = 0.3

    def jfn(m, v, s):
        return jnp.sum(jlik.expected_log_lik(name, jnp.asarray(y), m, v, {"noise": s}, opts))

    want = jlik.expected_log_lik(name, jnp.asarray(y), jnp.asarray(mean), jnp.asarray(var),
                                 {"noise": jnp.asarray(noise)}, opts)
    jgrads = jax.grad(jfn, argnums=(0, 1, 2))(jnp.asarray(mean), jnp.asarray(var),
                                              jnp.asarray(noise))
    tm, tv, ts = (torch.tensor(a, dtype=torch.float64, requires_grad=True)
                  for a in (mean, var, noise))
    got = likelihoods.expected_log_lik(name, torch.tensor(y), tm, tv, {"noise": ts}, opts)
    _close(got, want, 1e-12)
    got.sum().backward()
    for g, w in zip((tm.grad, tv.grad, ts.grad), jgrads):
        _close(torch.zeros(()) if g is None else g, w, 1e-12)


def test_gauss_hermite_and_predictive_transforms_match_jax():
    rng = np.random.default_rng(1)
    mean, var = rng.standard_normal(50), 0.01 + 3.0 * rng.random(50)
    y = rng.standard_normal(50)
    lp = lambda yy, f: -(yy - f) ** 2 * 0.5 + 0.1 * f ** 3
    _close(likelihoods.gauss_hermite(lp, *(torch.tensor(a) for a in (y, mean, var))),
           jlik.gauss_hermite(lp, *(jnp.asarray(a) for a in (y, mean, var))), 1e-12)
    m, v = torch.tensor(mean), torch.tensor(var)
    _close(likelihoods.predict_bernoulli(m, v),
           jlik.predict_bernoulli(jnp.asarray(mean), jnp.asarray(var)), 1e-12)
    for g, w in zip(likelihoods.predict_poisson(m, v),
                    jlik.predict_poisson(jnp.asarray(mean), jnp.asarray(var))):
        _close(g, w, 1e-12)


@pytest.mark.parametrize("name", ["gaussian", "bernoulli", "poisson", "student_t"])
def test_sample_observations_moments(name):
    """200 000 draws at each of three latent values: the sample mean and
    variance within 5 standard errors of the law's (for Student-t ν = 5,
    whose fourth moment is finite), values in the support, and the same
    draws again from a generator with the same seed."""
    f = torch.tensor([-0.7, 0.2, 1.1], dtype=torch.float64).repeat(200_000, 1)
    noise, df = 0.3, 5.0
    params, opts = {"noise": torch.tensor(noise, dtype=torch.float64)}, (("df", df),)
    gen = torch.Generator().manual_seed(0)
    draws = likelihoods.sample_observations(name, gen, f, params, opts)
    again = likelihoods.sample_observations(name, torch.Generator().manual_seed(0), f, params,
                                            opts)
    assert draws.shape == f.shape and draws.dtype == f.dtype and torch.equal(draws, again)
    f0 = f[0]
    if name == "gaussian":
        mean, var = f0, torch.full_like(f0, noise)
    elif name == "bernoulli":
        assert set(draws.unique().tolist()) <= {0.0, 1.0}
        mean = torch.special.ndtr(f0)
        var = mean * (1 - mean)
    elif name == "poisson":
        assert bool((draws == draws.round()).all() and (draws >= 0).all())
        mean = var = torch.exp(f0)
    else:
        mean, var = f0, torch.full_like(f0, noise * df / (df - 2.0))
    n = f.shape[0]
    got_mean, got_var = draws.mean(0), draws.var(0)
    # standard errors: of the mean √(var/n); of the variance √((μ₄ − σ⁴)/n)
    kurt = {"gaussian": 3.0, "student_t": 3.0 + 6.0 / (df - 4.0)}.get(name)
    mu4 = kurt * var ** 2 if kurt else ((draws - mean) ** 4).mean(0)
    assert bool(((got_mean - mean).abs() < 5 * torch.sqrt(var / n)).all()), (got_mean, mean)
    assert bool(((got_var - var).abs() < 5 * torch.sqrt((mu4 - var ** 2) / n)).all()), \
        (got_var, var)


def test_sample_observations_rejects_unknown_likelihood():
    with pytest.raises(ValueError, match="unknown likelihood"):
        likelihoods.sample_observations("laplace", torch.Generator(), torch.zeros(3))
    with pytest.raises(ValueError, match="unknown likelihood"):
        svgp.SVGPSpec(kinds=("matern12",) * 2,
                      features=tuple(CellIntegralFeature.from_lims(4, 0.0, 1.0)
                                     for _ in range(2)),
                      num_data=10, variational="kron", likelihood="laplace")


# --------------------------------------------------------------------------- #
# the Kronecker SVGP under each likelihood
# --------------------------------------------------------------------------- #

_M = (16, 12)
_NUM_DATA = 5000


def _svgp_specs(name, opts):
    kw = dict(kinds=("matern12",) * 2, num_data=_NUM_DATA, variational="kron",
              likelihood=name, likelihood_opts=opts)
    return (jsvgp.SVGPSpec(features=tuple(JaxCellFeature.from_lims(m, 0.0, 1.0) for m in _M),
                           **kw),
            svgp.SVGPSpec(features=tuple(CellIntegralFeature.from_lims(m, 0.0, 1.0) for m in _M),
                          **kw))


def _svgp_params_np():
    rng = np.random.default_rng(2)
    q = {"mu": 0.3 * rng.standard_normal(_M)}
    for i, m in enumerate(_M):
        q[f"raw_L{i + 1}"] = (np.asarray(jsvgp.raw_from_chol(jnp.eye(m)))
                              + 0.05 * np.tril(rng.standard_normal((m, m))))
    return {"axes": ({"variance": np.asarray(1.3), "lengthscale": np.asarray(0.2)},
                     {"variance": np.asarray(0.8), "lengthscale": np.asarray(0.3)}),
            "noise": np.asarray(0.05), "q": q}


def _svgp_batch(name, seed, n=128):
    rng = np.random.default_rng(seed)
    x = rng.random((n, 2))
    f = np.sin(6 * x[:, 0]) * np.cos(5 * x[:, 1])
    return x, _targets(name, f, rng)


def _sorted_leaves(tree):
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _sorted_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for v in tree for leaf in _sorted_leaves(v)]
    return [np.zeros(()) if tree is None else tree.detach().numpy()]


@pytest.mark.parametrize("name,opts", LIKELIHOODS, ids=_IDS)
def test_svgp_loss_and_gradients_match_jax(name, opts):
    """The minibatch loss (rtol 1e-10) and every gradient leaf (rtol 1e-7):
    the non-Gaussian likelihoods route through ``expected_log_lik``; where
    a likelihood ignores ``noise`` its gradient is zero on both sides."""
    jspec, tspec = _svgp_specs(name, opts)
    p_np = _svgp_params_np()
    x, y = _svgp_batch(name, 3)
    raw = jtrain.unconstrain(jax.tree.map(jnp.asarray, p_np))
    jval, jg = jax.jit(jax.value_and_grad(
        lambda r: jsvgp.loss(jspec, jtrain.constrain(r), jnp.asarray(x), jnp.asarray(y))))(raw)
    traw = train.raw_leaves_from(convert.params_from_jax(p_np, device="cpu",
                                                         dtype=torch.float64))
    tval = svgp.loss(tspec, train.constrain(traw), torch.tensor(x), torch.tensor(y))
    tval.backward()
    np.testing.assert_allclose(float(tval.detach()), float(jval), rtol=1e-10)
    for g, w in zip(_sorted_leaves(train.tree_map(lambda v: v.grad, traw)),
                    jax.tree.leaves(jg), strict=True):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=1e-7, atol=1e-7 * max(np.abs(w).max(), 1e-300))


@pytest.mark.parametrize("name,opts", LIKELIHOODS, ids=_IDS)
def test_svgp_predict_y_matches_jax(name, opts):
    """``predict_y`` at 60 points, rtol 1e-9: a Gaussian for gaussian and
    student_t, p(y* = 1) for bernoulli, (E[λ], Var[y]) for poisson."""
    jspec, tspec = _svgp_specs(name, opts)
    p_np = _svgp_params_np()
    xs = np.random.default_rng(4).random((60, 2))
    want = jsvgp.predict_y(jspec, jax.tree.map(jnp.asarray, p_np), jnp.asarray(xs))
    with torch.no_grad():
        got = svgp.predict_y(tspec, convert.params_from_jax(p_np, device="cpu",
                                                            dtype=torch.float64),
                             torch.tensor(xs))
    if name == "bernoulli":
        _close(got, want, 1e-9)
    elif name == "poisson":
        for g, w in zip(got, want, strict=True):
            _close(g, w, 1e-9)
    else:
        _close(got.mean, want.mean, 1e-9)
        _close(got.var, want.var, 1e-9)
        assert math.isfinite(float(got.var.min())) and float(got.var.min()) > 0
