"""The port's exact GP (``vggp_tpu_torch.models.exact``) against the JAX
package: the log marginal likelihood and its gradients, ``posterior``,
``prior``, and the gridded heads ``q_v`` and ``q_dv``, whose cell/point
covariances go through the ``cell_kuf`` kernel's wrapper (its plain version on
the CPU).

A 2-D Matérn-1/2 product model on 150 points, and 1-D Matérn-3/2 and RBF
models for the likelihood alone (the port's cell feature is Matérn-1/2
only). Both packages get the same numpy inputs in float64 on the CPU; the
likelihood is held at rtol 1e-10, gradient leaves at 1e-8, heads at rtol 1e-9
with atol 1e-9·max|ref|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vggp_tpu import train as jtrain
from vggp_tpu.features import CellIntegralFeature as JaxCellFeature
from vggp_tpu.models import exact as jexact

import vggp_tpu_torch
from vggp_tpu_torch import convert, train
from vggp_tpu_torch.features import CellIntegralFeature
from vggp_tpu_torch.models import exact
from vggp_tpu_torch.ops import cell_kuf as ck

RTOL_HEAD = 1e-9
_GRID = ((9, 0.0, 1.0), (7, -0.4, 1.3))


def _data(ndim, seed, n=150):
    rng = np.random.default_rng(seed)
    x = rng.random((n, ndim)) * np.array([1.0, 1.6][:ndim]) - np.array([0.0, 0.4][:ndim])
    y = np.sin(6 * x[:, 0]) * (np.cos(3 * x[:, 1]) if ndim == 2 else 1.0)
    return (x if ndim == 2 else x[:, 0]), y + 0.1 * rng.standard_normal(n)


def _params_np(ndim):
    axes = ({"variance": np.asarray(1.2), "lengthscale": np.asarray(0.25)},
            {"variance": np.asarray(0.7), "lengthscale": np.asarray(0.4)})[:ndim]
    return {"axes": axes, "noise": np.asarray(0.03)}


def _close(got, want, rtol=RTOL_HEAD):
    got = got.detach().numpy()
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())


def _gauss_close(got, want):
    _close(got.mean, want.mean)
    if want.cov is not None:
        assert got.var is None
        _close(got.cov, want.cov)
    else:
        assert got.cov is None
        _close(got.var, want.var)


def _sorted_leaves(tree):
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _sorted_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for v in tree for leaf in _sorted_leaves(v)]
    return [tree.detach().numpy()]


@pytest.mark.parametrize("kinds", [("matern12", "matern12"), ("matern32",), ("rbf",)])
def test_mll_and_gradients_match_jax(kinds):
    ndim = len(kinds)
    x, y = _data(ndim, 0)
    p_np = _params_np(ndim)
    jspec, tspec = jexact.ExactGPSpec(kinds), exact.ExactGPSpec(kinds)
    raw = jtrain.unconstrain(jax.tree.map(jnp.asarray, p_np))
    jval, jg = jax.jit(jax.value_and_grad(
        lambda r: jexact.loss(jspec, jtrain.constrain(r), jnp.asarray(x), jnp.asarray(y))))(raw)
    traw = train.raw_leaves_from(convert.params_from_jax(p_np, device="cpu",
                                                         dtype=torch.float64))
    tval = exact.loss(tspec, train.constrain(traw), torch.tensor(x), torch.tensor(y))
    tval.backward()
    np.testing.assert_allclose(float(tval.detach()), float(jval), rtol=1e-10)
    np.testing.assert_allclose(float(exact.mll(tspec, convert.params_from_jax(
        p_np, device="cpu"), torch.tensor(x), torch.tensor(y))), -float(jval), rtol=1e-10)
    for g, w in zip(_sorted_leaves(train.tree_map(lambda v: v.grad, traw)),
                    jax.tree.leaves(jg), strict=True):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-8)


_HEADS = ["posterior", "posterior_full", "posterior_predictive", "posterior_predictive_full",
          "prior", "q_v", "q_v_full", "q_dv0", "q_dv0_full", "q_dv1", "q_dv1_full"]


def _run_head(mod, spec, p, X, y, xs, grid, head):
    full = head.endswith("_full")
    if head.startswith("posterior_predictive"):
        return mod.posterior_predictive(spec, p, X, y, xs, full_cov=full)
    if head.startswith("posterior"):
        return mod.posterior(spec, p, X, y, xs, full_cov=full)
    if head == "prior":
        return mod.prior(spec, p, xs)
    if head.startswith("q_v"):
        return mod.q_v(spec, p, X, y, grid, full_cov=full)
    return mod.q_dv(spec, p, X, y, grid, int(head[4]), full_cov=full)


_KINDS = ("matern12", "matern12")


@pytest.fixture(scope="module")
def jax_heads():
    """Every JAX head of the 2-D model, from one compiled program."""
    x, y = _data(2, 1)
    xs = _data(2, 2, 30)[0]
    grid = tuple(JaxCellFeature.from_lims(*g) for g in _GRID)
    spec = jexact.ExactGPSpec(_KINDS)
    run = lambda p, X, Y, XS: {h: _run_head(jexact, spec, p, X, Y, XS, grid, h) for h in _HEADS}
    return jax.jit(run)(jax.tree.map(jnp.asarray, _params_np(2)),
                        *(jnp.asarray(a) for a in (x, y, xs)))


@pytest.mark.parametrize("head", _HEADS)
def test_heads_match_jax(jax_heads, head, monkeypatch):
    """Each head at rtol 1e-9; ``q_v`` reaches the cell-Kuf wrapper once per
    axis, ``q_dv`` once (the other axis), the posterior heads never."""
    x, y = _data(2, 1)
    xs = _data(2, 2, 30)[0]
    grid = tuple(CellIntegralFeature.from_lims(*g) for g in _GRID)
    p = convert.params_from_jax(_params_np(2), device="cpu", dtype=torch.float64)
    calls = []
    real = ck.cell_kuf
    monkeypatch.setattr(ck, "cell_kuf", lambda *a: calls.append(1) or real(*a))
    with torch.no_grad():
        got = _run_head(exact, exact.ExactGPSpec(_KINDS), p, torch.tensor(x), torch.tensor(y),
                        torch.tensor(xs), grid, head)
    assert len(calls) == {"q_v": 2, "q_d": 1}.get(head[:3], 0)
    _gauss_close(got, jax_heads[head])


def test_exact_module_and_convert_round_trip():
    p_np = _params_np(2)
    back = convert.params_to_numpy(convert.params_from_jax(p_np, device="cpu"))
    assert sorted(back) == ["axes", "noise"]
    for g, w in zip(jax.tree.leaves(back), jax.tree.leaves(p_np), strict=True):
        np.testing.assert_array_equal(g, w)
    x, y = _data(2, 3)
    X, Y = torch.tensor(x), torch.tensor(y)
    spec = exact.ExactGPSpec(_KINDS)
    p = convert.params_from_jax(p_np, device="cpu", dtype=torch.float64)
    model = vggp_tpu_torch.ExactGP(spec, X, Y, p, dtype=torch.float64, device="cpu")
    assert len(list(model.parameters())) == 5
    np.testing.assert_allclose(float(model().detach()), float(exact.loss(spec, p, X, Y)),
                               rtol=1e-12)
    grid = tuple(CellIntegralFeature.from_lims(*g) for g in _GRID)
    xs = X[:7]
    with torch.no_grad():
        pairs = [(model.posterior(xs), exact.posterior(spec, p, X, Y, xs, full_cov=False)),
                 (model.q_v(grid), exact.q_v(spec, p, X, Y, grid, full_cov=False)),
                 (model.q_dv(grid, axis=1), exact.q_dv(spec, p, X, Y, grid, 1, False))]
    for got, want in pairs:
        _close(got.mean, want.mean.numpy(), 1e-12)
        _close(got.var, want.var.numpy(), 1e-12)
    final, hist = train.fit(lambda q: exact.loss(spec, q, X, Y),
                            train.non_informative_init(spec.init_params(torch.float64, "cpu"),
                                                       X, Y), 5, 0.05)
    assert hist["loss"].shape == (5,) and float(hist["loss"][-1]) < float(hist["loss"][0])


@pytest.mark.parametrize("what", ["coregion", "per_output_noise", "learned_mean",
                                  "posterior_grad"])
def test_unported_options_raise(what):
    if what == "posterior_grad":
        # ported since: a Matérn-1/2 axis raises what the JAX package raises
        for mod, X, y, xs, p_of in (
                (jexact, jnp.ones((5, 2)) * 0.3, jnp.ones(5), jnp.ones((3, 2)) * 0.4,
                 lambda spec: spec.init_params()),
                (exact, torch.rand(5, 2), torch.rand(5), torch.rand(3, 2),
                 lambda spec: spec.init_params(device="cpu"))):
            spec = mod.ExactGPSpec(_KINDS)
            with pytest.raises(ValueError, match="once-differentiable"):
                mod.posterior_grad(spec, p_of(spec), X, y, xs, axis=0)
        return
    if what == "learned_mean":
        # ported since: a per-output mean vector without a coregion axis
        # raises what the JAX package raises
        for mod, X, y, vec, p_of in (
                (jexact, jnp.ones((5, 2)) * 0.3, jnp.ones(5), jnp.zeros(2),
                 lambda spec: spec.init_params()),
                (exact, torch.rand(5, 2), torch.rand(5), torch.zeros(2),
                 lambda spec: spec.init_params(device="cpu"))):
            spec = mod.ExactGPSpec(_KINDS, learn_mean=True)
            with pytest.raises(ValueError, match="per-output mean"):
                mod.loss(spec, {**p_of(spec), "mean": vec}, X, y)
        return
    # ported since: the coregion axis, with and without per-output noise,
    # gives JAX's initial parameters and mll (rtol 1e-10)
    rng = np.random.default_rng(3)
    X = np.stack([rng.random(10), rng.integers(0, 2, 10).astype(np.float64)], 1)
    y = rng.random(10)
    kw = dict(kinds=("matern12", "coregion"), n_outputs=2,
              per_output_noise=what == "per_output_noise")
    jspec, tspec = jexact.ExactGPSpec(**kw), exact.ExactGPSpec(**kw)
    p_np = jax.tree.map(np.asarray, jspec.init_params(jnp.float64))
    tp = tspec.init_params(torch.float64, "cpu")
    for g, w in zip(jax.tree.leaves(convert.params_to_numpy(tp)), jax.tree.leaves(p_np),
                    strict=True):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_allclose(float(exact.mll(tspec, tp, torch.tensor(X), torch.tensor(y))),
                               float(jexact.mll(jspec, jax.tree.map(jnp.asarray, p_np),
                                                jnp.asarray(X), jnp.asarray(y))), rtol=1e-10)
