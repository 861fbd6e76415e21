"""The port's full variational family of the SVGP, with the learned
constant mean, against the JAX package.

Configurations of the full family, 1-D and 2-D, with and without the
learned mean: Matérn-1/2 cells (the scalar-tangent path with the closed-form
F⁻¹), Matérn-3/2 cells (the dense factor, the gradient heads), inducing
points (z learned, autograd through the Cholesky) and VFF. Parameters come
from a numpy seed. Both packages get the same numpy inputs in float64 on
the CPU (JAX in x64, its Pallas kernels in interpret mode). Losses are held
at rtol 1e-10, gradient leaves at 1e-7 (as ``tests/test_torch_sgpr.py``
holds them), heads at rtol 1e-9 with atol 1e-9·max|ref|.
``tests/test_torch_zoo.py`` holds the collapsed zoo, ``tests/test_torch_mean.py``
the learned mean of the collapsed and exact GPs, the modules and ``convert``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vggp_tpu import features as jfeatures
from vggp_tpu import train as jtrain
from vggp_tpu.models import svgp as jsvgp

from vggp_tpu_torch import convert, features, train
from vggp_tpu_torch.models import svgp

RTOL_LOSS = 1e-10
RTOL_GRAD = 1e-7
RTOL_FIT = 1e-6
RTOL_HEAD = 1e-9


def _close(got, want, rtol=RTOL_HEAD):
    want, got = (v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
                 for v in (want, got))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(np.abs(want).max(), 1e-300))


def _gauss_close(got, want, rtol=RTOL_HEAD):
    _close(got.mean, want.mean, rtol)
    if want.cov is not None:
        assert got.var is None
        _close(got.cov, want.cov, rtol)
    else:
        assert got.cov is None
        _close(got.var, want.var, rtol)


def _port_feature(jf):
    """The port's feature of the same numpy arguments as the JAX one."""
    if isinstance(jf, jfeatures.PointFeature):
        return features.PointFeature(jf.m, jf.z_init)
    if isinstance(jf, jfeatures.FourierFeature):
        return features.FourierFeature(jf.n_frequencies, jf.a, jf.b)
    if isinstance(jf, jfeatures.B1SplineFeature):
        return features.B1SplineFeature(jf.mesh)
    if isinstance(jf, jfeatures.SplineRKHSFeature):
        return features.SplineRKHSFeature(jf.degree, jf.n_intervals, jf.a, jf.b)
    return features.CellIntegralFeature(jf.mesh)


def _torch_flat(tree):
    """Leaves in ``jax.tree.leaves`` order (dict keys sorted); a gradient
    that autograd left as None is a zero."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _torch_flat(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for v in tree for leaf in _torch_flat(v)]
    return [np.zeros(()) if tree is None else tree.detach().numpy()]


def _to_torch(p_np):
    return convert.params_from_jax(p_np, device="cpu", dtype=torch.float64)


def _jax_value_and_grad(loss_fn, p_np):
    raw = jtrain.unconstrain(jax.tree.map(jnp.asarray, p_np))
    val, g = jax.jit(jax.value_and_grad(lambda r: loss_fn(jtrain.constrain(r))))(raw)
    return float(val), [np.asarray(v) for v in jax.tree.leaves(g)]


def _torch_value_and_grad(loss_fn, p_np):
    raw = train.raw_leaves_from(_to_torch(p_np))
    val = loss_fn(train.constrain(raw))
    val.backward()
    return float(val.detach()), _torch_flat(train.tree_map(lambda v: v.grad, raw))


def _check_value_and_grad(jloss, tloss, p_np):
    jval, jg = _jax_value_and_grad(jloss, p_np)
    tval, tg = _torch_value_and_grad(tloss, p_np)
    np.testing.assert_allclose(tval, jval, rtol=RTOL_LOSS)
    assert len(tg) == len(jg)
    for g, w in zip(tg, jg, strict=True):
        _close(g, w, RTOL_GRAD)


# --------------------------------------------------------------------------- #
# the full variational family of the SVGP
# --------------------------------------------------------------------------- #

# (per-axis JAX features, kinds, learned mean)
_SVGP = {
    "1d-cells": (lambda: (jfeatures.CellIntegralFeature.from_lims(24, 0.0, 1.0),),
                 ("matern12",), False),
    "1d-cells-mean": (lambda: (jfeatures.CellIntegralFeature.from_lims(24, 0.0, 1.0),),
                      ("matern12",), True),
    "2d-cells-mean": (lambda: (jfeatures.CellIntegralFeature.from_lims(8, 0.0, 1.0),
                               jfeatures.CellIntegralFeature.from_lims(7, -0.5, 1.5)),
                      ("matern12", "matern12"), True),
    "2d-matern32": (lambda: (jfeatures.CellIntegralFeature.from_lims(6, 0.0, 1.0),
                             jfeatures.CellIntegralFeature.from_lims(5, -0.5, 1.5)),
                    ("matern32", "matern32"), False),
    "1d-points-mean": (lambda: (jfeatures.PointFeature(10, np.linspace(0.05, 0.95, 10)),),
                       ("matern32",), True),
    "1d-vff": (lambda: (jfeatures.FourierFeature(6, -0.1, 1.1),), ("matern52",), False),
}
_PARAMS = ((1.3, 0.12), (0.8, 0.3))


def _svgp_specs(name):
    make, kinds, mean = _SVGP[name]
    jf = make()
    common = dict(kinds=kinds, num_data=400, variational="full", learn_mean=mean,
                  jitter=1e-5 if "matern32" in kinds else 1e-6)
    return (jsvgp.SVGPSpec(features=jf, **common),
            svgp.SVGPSpec(features=tuple(_port_feature(f) for f in jf), **common))


def _svgp_params(name):
    jspec, _ = _svgp_specs(name)
    rng = np.random.default_rng(4)
    m = jspec.num_inducing
    axes = []
    for (v, ell), f in zip(_PARAMS, jspec.features):
        ax = {"variance": np.asarray(v), "lengthscale": np.asarray(ell)}
        if isinstance(f, jfeatures.PointFeature):
            ax["z"] = np.asarray(f.z_init) + 0.01 * rng.standard_normal(f.m)
        axes.append(ax)
    p = {"axes": tuple(axes), "noise": np.asarray(0.04),
         "q": {"mu": 0.3 * rng.standard_normal(m),
               "raw_L": (np.asarray(jsvgp.raw_from_chol(jnp.eye(m)))
                         + 0.05 * np.tril(rng.standard_normal((m, m))))}}
    if jspec.learn_mean:
        p["mean"] = np.asarray(0.35)
    return p


def _svgp_data(name, seed, n):
    rng = np.random.default_rng(seed)
    nd = len(_SVGP[name][1])
    x = rng.random((n, nd)) * np.array([1.2, 2.2][:nd]) - np.array([0.1, 0.6][:nd])
    y = np.sin(6 * x[:, 0]) * (np.cos(3 * x[:, 1]) if nd == 2 else 1.0) + 0.1 * rng.standard_normal(n)
    return (x if nd == 2 else x[:, 0]), y


def _serving(name):
    """(query points, serving grids) of a configuration."""
    xs, _ = _svgp_data(name, 9, 17)
    nd = len(_SVGP[name][1])
    lims = ((5, 0.1, 0.9), (6, -0.3, 1.2))[:nd]
    return xs, lims


@pytest.mark.parametrize("name", sorted(_SVGP))
def test_full_family_loss_and_gradients_match_jax(name):
    """The minibatch loss (rtol 1e-10) and every gradient leaf (rtol 1e-7):
    the axes (z of a point feature included), the noise, μ, raw_L and the
    learned mean."""
    jspec, tspec = _svgp_specs(name)
    x, y = _svgp_data(name, 0, 90)
    _check_value_and_grad(lambda p: jsvgp.loss(jspec, p, jnp.asarray(x), jnp.asarray(y)),
                          lambda p: svgp.loss(tspec, p, torch.tensor(x), torch.tensor(y)),
                          _svgp_params(name))


def _heads(mod, spec, p, xs, grids, arr):
    """Every head of the full family, cold and from ``precompute``."""
    xs = arr(xs)
    state = mod.precompute(spec, p)
    out = {
        "kl": mod.kl(spec, p),
        "posterior": mod.posterior(spec, p, xs),
        "posterior full_cov": mod.posterior(spec, p, xs, full_cov=True),
        "posterior predictive full_cov": mod.posterior(spec, p, xs, full_cov=True,
                                                       predictive=True),
        "posterior_from_state": mod.posterior_from_state(spec, p, state, xs),
        "posterior_from_state full_cov": mod.posterior_from_state(spec, p, state, xs,
                                                                  full_cov=True),
        "predict_y": mod.predict_y(spec, p, xs),
        "prior": mod.prior(spec, p, xs),
        "q_u": mod.q_u(spec, p),
        "p_v_u": mod.p_v_u(spec, p, grids),
        "q_v": mod.q_v(spec, p, grids),
        "q_v full_cov": mod.q_v(spec, p, grids, full_cov=True),
        "q_v own": mod.q_v(spec, p, spec.features if isinstance(
            spec.features[0], (features.CellIntegralFeature,
                                jfeatures.CellIntegralFeature)) else grids),
        "q_v_from_state": mod.q_v_from_state(spec, p, state, grids),
        "q_dv axis 0": mod.q_dv(spec, p, grids, 0),
        "q_dv full_cov axis 0": mod.q_dv(spec, p, grids, 0, full_cov=True),
        "q_dv_from_state axis 0": mod.q_dv_from_state(spec, p, state, grids, 0),
    }
    if spec.kinds[0] != "matern12":
        for a in range(spec.ndim):
            out[f"posterior_grad axis {a}"] = mod.posterior_grad(spec, p, xs, a)
            out[f"posterior_grad full_cov axis {a}"] = mod.posterior_grad(spec, p, xs, a,
                                                                          full_cov=True)
            out[f"posterior_grad_from_state axis {a}"] = mod.posterior_grad_from_state(
                spec, p, state, xs, a)
    return out


# the configurations whose heads are held: 1-D and 2-D, with and without the
# learned mean, the dense autograd path of the points
_HEAD_CASES = ("1d-cells-mean", "2d-cells-mean", "2d-matern32", "1d-points-mean")


@pytest.fixture(scope="module")
def jax_heads():
    """Every JAX head of every configuration, one compiled program each."""
    out = {}
    for name in _HEAD_CASES:
        jspec, _ = _svgp_specs(name)
        xs, lims = _serving(name)
        grids = tuple(jfeatures.CellIntegralFeature.from_lims(*g) for g in lims)
        run = jax.jit(lambda p, jspec=jspec, xs=xs, grids=grids: _heads(
            jsvgp, jspec, p, xs, grids, jnp.asarray))
        out[name] = run(jax.tree.map(jnp.asarray, _svgp_params(name)))
    return out


@pytest.mark.parametrize("name", _HEAD_CASES)
@pytest.mark.parametrize("grad", [False, True])
def test_full_family_heads_match_jax(jax_heads, name, grad):
    """Every head, cold and warm, marginal and full_cov, with the learned
    mean added back where the model has one, rtol 1e-9. Under no_grad the
    cold heads take the warm path on a fresh state; with parameters that
    require grad they take the training path (the scalar-tangent blocks
    where the basis is fixed)."""
    jspec, tspec = _svgp_specs(name)
    xs, lims = _serving(name)
    grids = tuple(features.CellIntegralFeature.from_lims(*g) for g in lims)
    p = _to_torch(_svgp_params(name))
    if grad:
        p = train.tree_map(lambda v: v.requires_grad_(), p)
        got = _heads(svgp, tspec, p, xs, grids, torch.as_tensor)
    else:
        with torch.no_grad():
            got = _heads(svgp, tspec, p, xs, grids, torch.as_tensor)
    want = jax_heads[name]
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if isinstance(w, jsvgp.Gaussian):
            _gauss_close(got[k], w)
        else:
            _close(got[k], w)


@pytest.mark.parametrize("name", ("1d-cells-mean", "1d-points-mean"))
def test_elbo_mu_s_matches_jax(name):
    """``elbo_muS`` at an explicit (μ, S = LLᵀ): its value (rtol 1e-10) and
    its gradients in μ, S and every parameter leaf (rtol 1e-7); the
    Kronecker family raises ValueError in both packages."""
    jspec, tspec = _svgp_specs(name)
    x, y = _svgp_data(name, 2, 70)
    p_np = _svgp_params(name)
    m = jspec.num_inducing
    rng = np.random.default_rng(6)
    mu = 0.2 * rng.standard_normal(m)
    L = np.eye(m) * 0.8 + 0.05 * np.tril(rng.standard_normal((m, m)), -1)
    S = L @ L.T
    jp = jax.tree.map(jnp.asarray, p_np)
    jval, (jg_p, jg_mu, jg_S) = jax.jit(jax.value_and_grad(
        lambda p, mu, S: jsvgp.elbo_muS(jspec, p, mu, S, jnp.asarray(x), jnp.asarray(y)),
        argnums=(0, 1, 2)))(jp, jnp.asarray(mu), jnp.asarray(S))
    tp = train.tree_map(lambda v: v.requires_grad_(), _to_torch(p_np))
    tmu, tS = (torch.tensor(a, requires_grad=True) for a in (mu, S))
    tval = svgp.elbo_muS(tspec, tp, tmu, tS, torch.tensor(x), torch.tensor(y))
    tval.backward()
    np.testing.assert_allclose(float(tval.detach()), float(jval), rtol=RTOL_LOSS)
    _close(tmu.grad, jg_mu, RTOL_GRAD)
    _close(tS.grad, jg_S, RTOL_GRAD)
    # q is not read (zero gradients in JAX, none in torch)
    for g, w in zip(_torch_flat(train.tree_map(lambda v: v.grad, tp)), jax.tree.leaves(jg_p),
                    strict=True):
        _close(np.broadcast_to(g, w.shape), w, RTOL_GRAD)
    kron = svgp.SVGPSpec(kinds=("matern12",) * 2, num_data=10, variational="kron",
                         features=tuple(features.CellIntegralFeature.from_lims(4, 0.0, 1.0)
                                        for _ in range(2)))
    with pytest.raises(ValueError, match="full variational family"):
        svgp.elbo_muS(kron, kron.init_params(torch.float64, "cpu"), tmu, tS,
                      torch.rand(3, 2), torch.rand(3))
