"""The learned constant mean of the port's models, their modules and the
conversion of the new parameter leaves, against the JAX package.

The mean in the collapsed zoo of ``vggp_tpu/experiments/zoo.py`` (nb1) and
in the exact GP, the 1-D full-family SVGP with inducing points and a mean
through ``train.fit_minibatch`` and its module, and ``convert`` on a tree
with z, the full family's q and a mean. Both packages get the same numpy
inputs in float64 on the CPU (JAX in x64). Losses are held at rtol 1e-10,
gradient leaves at 1e-7, inits at 1e-12, heads at rtol 1e-9 with atol
1e-9·max|ref|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vggp_tpu import features as jfeatures
from vggp_tpu import train as jtrain
from vggp_tpu.models import exact as jexact
from vggp_tpu.models import sgpr as jsgpr

import vggp_tpu_torch
from vggp_tpu_torch import convert, features, train
from vggp_tpu_torch.models import exact, sgpr, svgp

from test_torch_full import (_check_value_and_grad, _close, _gauss_close, _svgp_data,
                             _svgp_params, _svgp_specs, _to_torch, _torch_flat)
from test_torch_zoo import _zoo_data, _zoo_specs


@pytest.mark.parametrize("model", ("svgp", "vffgp", "asvgp", "griddedgp"))
def test_zoo_learned_mean_matches_jax(model):
    """The 1-D zoo with a learned mean: ``init_params`` and
    ``non_informative_init`` (the mean at the sample mean, rtol 1e-12), the
    ELBO (rtol 1e-10) and its gradient leaves, the mean's among them (rtol
    1e-7), and the posterior, q_v and p_v_u with the mean added back (rtol
    1e-9)."""
    jspec, tspec = _zoo_specs("1d", model, learn_mean=True)
    x, y = _zoo_data("1d", 2)
    y = y + 1.7
    jx, jy, tx, ty = jnp.asarray(x), jnp.asarray(y), torch.tensor(x), torch.tensor(y)
    jp0 = jtrain.non_informative_init(jspec.init_params(jnp.float64), jx, jy)
    tp0 = train.non_informative_init(tspec.init_params(torch.float64, "cpu"), tx, ty)
    for g, w in zip(_torch_flat(tp0), jax.tree.leaves(jp0), strict=True):
        _close(g, w, 1e-12)
    p_np = {**jax.tree.map(np.asarray, jp0), "mean": np.asarray(1.2)}
    _check_value_and_grad(lambda p: jsgpr.loss(jspec, p, jx, jy),
                          lambda p: sgpr.loss(tspec, p, tx, ty), p_np)
    grid = ((5, -0.05, 1.05),)
    jgrid = tuple(jfeatures.CellIntegralFeature.from_lims(*g) for g in grid)
    tgrid = tuple(features.CellIntegralFeature.from_lims(*g) for g in grid)
    jp, tp = jax.tree.map(jnp.asarray, p_np), _to_torch(p_np)
    xs = np.linspace(-0.1, 1.1, 9)
    with torch.no_grad():
        pairs = [(sgpr.posterior(tspec, tp, tx, ty, torch.tensor(xs), full_cov=False),
                  jsgpr.posterior(jspec, jp, jx, jy, jnp.asarray(xs), full_cov=False)),
                 (sgpr.q_v(tspec, tp, tx, ty, tgrid), jsgpr.q_v(jspec, jp, jx, jy, jgrid)),
                 (sgpr.p_v_u(tspec, tp, tx, ty, tgrid), jsgpr.p_v_u(jspec, jp, jx, jy, jgrid))]
    for got, want in pairs:
        _gauss_close(got, want)


def test_exact_learned_mean_matches_jax():
    """The exact GP with a learned mean (2-D, Matérn-3/2): ``init_params``,
    the mll (rtol 1e-10) and its gradients (rtol 1e-7), the posterior, q_v
    and the module's raw tree, which carries ``mean``."""
    kinds = ("matern32", "matern32")
    jspec, tspec = jexact.ExactGPSpec(kinds, learn_mean=True), exact.ExactGPSpec(
        kinds, learn_mean=True)
    for g, w in zip(_torch_flat(tspec.init_params(torch.float64, "cpu")),
                    jax.tree.leaves(jspec.init_params(jnp.float64)), strict=True):
        np.testing.assert_array_equal(g, w)
    x, y = _zoo_data("2d", 5, 60)
    y = y - 0.8
    p_np = {"axes": ({"variance": np.asarray(1.1), "lengthscale": np.asarray(0.3)},
                     {"variance": np.asarray(0.7), "lengthscale": np.asarray(0.4)}),
            "noise": np.asarray(0.03), "mean": np.asarray(-0.6)}
    jx, jy, tx, ty = jnp.asarray(x), jnp.asarray(y), torch.tensor(x), torch.tensor(y)
    _check_value_and_grad(lambda p: jexact.loss(jspec, p, jx, jy),
                          lambda p: exact.loss(tspec, p, tx, ty), p_np)
    grid = ((4, 0.0, 1.0), (3, 0.2, 0.8))
    jgrid = tuple(jfeatures.CellIntegralFeature.from_lims(*g) for g in grid)
    tgrid = tuple(features.CellIntegralFeature.from_lims(*g) for g in grid)
    jp, tp = jax.tree.map(jnp.asarray, p_np), _to_torch(p_np)
    xs = np.random.default_rng(6).random((7, 2))
    _gauss_close(exact.posterior(tspec, tp, tx, ty, torch.tensor(xs)),
                 jexact.posterior(jspec, jp, jx, jy, jnp.asarray(xs)))
    _gauss_close(exact.q_v(tspec, tp, tx, ty, tgrid), jexact.q_v(jspec, jp, jx, jy, jgrid))
    model = vggp_tpu_torch.ExactGP(tspec, tx, ty, tp, dtype=torch.float64, device="cpu")
    assert "mean" in model.raw_params()
    _close(model(), exact.loss(tspec, tp, tx, ty), 1e-14)


def test_full_family_fit_minibatch_and_module():
    """The 1-D full-family SVGP with a learned mean trains through
    ``train.fit_minibatch`` (the loss falls) and through the module, whose
    raw tree carries ``mean`` and ``q = {mu, raw_L}`` and whose forward is
    the loss; the init leaves match JAX's ``init_params`` exactly."""
    jspec, tspec = _svgp_specs("1d-points-mean")
    p0 = tspec.init_params(torch.float64, "cpu")
    for g, w in zip(_torch_flat(p0), jax.tree.leaves(jspec.init_params(jnp.float64)),
                    strict=True):
        _close(g, w, 1e-15)
    x, y = (torch.tensor(a) for a in _svgp_data("1d-points-mean", 3, 300))
    p0 = train.non_informative_init(p0, x, y)
    final, hist = train.fit_minibatch(lambda p, xb, yb: svgp.loss(tspec, p, xb, yb), p0, x, y,
                                      30, 64, learning_rate=0.02)
    assert float(hist["loss"][-5:].mean()) < float(hist["loss"][:5].mean())
    assert abs(float(final["mean"]) - float(p0["mean"])) > 0
    model = svgp.SVGP(tspec, p0, dtype=torch.float64)
    raw = model.raw_params()
    assert sorted(raw) == ["axes", "mean", "noise", "q"] and sorted(raw["q"]) == ["mu", "raw_L"]
    assert "z" in raw["axes"][0]
    _close(model(x[:50], y[:50]), svgp.loss(tspec, model.params(), x[:50], y[:50]), 1e-15)
    assert sorted(dict(model.named_parameters())) == sorted(
        ["axes.0.variance", "axes.0.lengthscale", "axes.0.z", "noise", "mean", "q.mu",
         "q.raw_L"])


def test_convert_carries_the_new_leaves():
    """``params_from_jax`` on a JAX tree with a point feature's z, the full
    family's q = {mu, raw_L} and a learned mean: every leaf, its shape and
    dtype, exactly; ``params_to_numpy`` brings them back."""
    jspec, tspec = _svgp_specs("1d-points-mean")
    jp = jax.tree.map(np.asarray, jax.tree.map(jnp.asarray, _svgp_params("1d-points-mean")))
    tp = convert.params_from_jax(jp, device="cpu")
    assert sorted(tp) == ["axes", "mean", "noise", "q"]
    assert sorted(tp["q"]) == ["mu", "raw_L"] and "z" in tp["axes"][0]
    for g, w in zip(_torch_flat(tp), jax.tree.leaves(jp), strict=True):
        np.testing.assert_array_equal(g, w)
    back = convert.params_to_numpy(tp)
    for g, w in zip(jax.tree.leaves(back), jax.tree.leaves(jp), strict=True):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    f32 = convert.params_from_jax(jp, device="cpu", dtype=torch.float32)
    assert all(t.dtype == torch.float32 for t in train.tree_leaves(f32))
