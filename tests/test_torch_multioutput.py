"""The multi-output (ICM) models of the port against the JAX package: the
coregion axis (``kernels.coregion_b``, its gathers, ``OutputFeature``), the
per-output noise and mean, the Kronecker and full-family SVGP, the collapsed
GP and the exact GP on it, the inits on a coregion spec and ``convert`` on
the new leaves.

Both packages get the same numpy inputs, made from a seed, in float64 on the
CPU (JAX in x64). Tolerances as the other port tests': blocks and heads at
rtol 1e-9 (atol 1e-9·max|ref|), losses at rtol 1e-10, gradient leaves at
1e-7, fits and inits at 1e-6 and 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vggp_tpu import features as jfeatures
from vggp_tpu import kernels as jkernels
from vggp_tpu import train as jtrain
from vggp_tpu.models import common as jcommon
from vggp_tpu.models import exact as jexact
from vggp_tpu.models import sgpr as jsgpr
from vggp_tpu.models import svgp as jsvgp

import vggp_tpu_torch
from vggp_tpu_torch import convert, features, kernels, train
from vggp_tpu_torch.models import common, exact, sgpr, svgp

from test_torch_full import (RTOL_FIT, _check_value_and_grad, _close, _gauss_close, _to_torch,
                             _torch_flat)


def _b_params(P, R, seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((P, R)), "kappa": rng.uniform(0.1, 1.0, P)}


def _both(p_np):
    return jax.tree.map(jnp.asarray, p_np), _to_torch(p_np)


@pytest.mark.parametrize("P,R", ((2, 1), (3, 2)))
def test_coregion_b_and_gathers_match_jax(P, R):
    """B = WWᵀ + diag κ and its diagonal, and the coregion branches of
    ``axis_gram`` and ``axis_kdiag`` at integer indices, rtol 1e-12; the
    stationary branch is unchanged (rtol 1e-12 against ``gram_1d``)."""
    jp, tp = _both(_b_params(P, R, P))
    _close(kernels.coregion_b(tp), jkernels.coregion_b(jp), 1e-12)
    _close(kernels.coregion_b_diag(tp), jkernels.coregion_b_diag(jp), 1e-12)
    i1 = np.array([0, P - 1, 1, 0], dtype=np.float64)
    i2 = np.array([P - 1, 1, 0], dtype=np.float64)
    _close(kernels.axis_gram("coregion", tp, torch.tensor(i1), torch.tensor(i2)),
           jkernels.axis_gram("coregion", jp, jnp.asarray(i1), jnp.asarray(i2)), 1e-12)
    _close(kernels.axis_kdiag("coregion", tp, torch.tensor(i1)),
           jkernels.axis_kdiag("coregion", jp, jnp.asarray(i1)), 1e-12)
    ps = {"variance": np.asarray(1.3), "lengthscale": np.asarray(0.4)}
    x1, x2 = np.linspace(0, 1, 7), np.linspace(0, 1, 5)
    _close(kernels.axis_gram("matern32", _to_torch(ps), torch.tensor(x1), torch.tensor(x2)),
           jkernels.axis_gram("matern32", jax.tree.map(jnp.asarray, ps), jnp.asarray(x1),
                              jnp.asarray(x2)), 1e-12)


@pytest.mark.parametrize("P,R", ((2, 1), (3, 2)))
def test_output_feature_matches_jax(P, R):
    """``OutputFeature``: the same W and κ from the fixed generator
    (exactly), m, and Kuu, Kuf and Kvu (rtol 1e-12); the errors JAX raises
    for a wrong kind, a mismatched grid axis and bad sizes."""
    jf, tf = jfeatures.OutputFeature(P, R), features.OutputFeature(P, R)
    assert tf.m == jf.m == P
    for g, w in zip(_torch_flat(tf.init_params(torch.float64, "cpu")),
                    jax.tree.leaves(jf.init_params(jnp.float64)), strict=True):
        np.testing.assert_array_equal(g, w)
    jp, tp = _both(_b_params(P, R, 7))
    x = np.array([0.0, P - 1.0, 1.0, 0.0, 1.0])
    _close(tf.Kuu("coregion", tp), jf.Kuu("coregion", jp), 1e-12)
    _close(tf.Kuf("coregion", tp, torch.tensor(x)), jf.Kuf("coregion", jp, jnp.asarray(x)), 1e-12)
    _close(tf.Kvu("coregion", tp, features.OutputFeature(P, 1)),
           jf.Kvu("coregion", jp, jfeatures.OutputFeature(P, 1)), 1e-12)
    for pkg, f, p, xx in ((jfeatures, jf, jp, jnp.asarray(x)),
                          (features, tf, tp, torch.tensor(x))):
        with pytest.raises(ValueError, match="pairs with kind='coregion'"):
            f.Kuu("matern12", p)
        with pytest.raises(ValueError, match="must be the same outputs"):
            f.Kvu("coregion", p, pkg.OutputFeature(P + 1, 1))
        with pytest.raises(ValueError, match="must be the same outputs"):
            f.Kvu("coregion", p, pkg.CellIntegralFeature.from_lims(4, 0.0, 1.0))
        for bad in ((0, 1), (2, 3), (2, 0)):
            with pytest.raises(ValueError, match="need n_outputs"):
                pkg.OutputFeature(*bad)


@pytest.mark.parametrize("index", (2.0, 0.5, -1.0, 1.25, 3.0))
def test_invalid_output_index_poisons_and_clips_as_jax(index):
    """An output index that is not an integer in [0, P) (P = 2): the
    Grams, the diagonal and Kuf carry NaN exactly where JAX's do, the
    rest equal (rtol 1e-12); the per-output mean and noise gather the
    value JAX's clipped gather reads (round half to even, a negative index
    wrapped once, then clipped). No IndexError, which on the card is a
    device assert."""
    jp, tp = _both(_b_params(2, 1, 3))
    x = np.array([0.0, 1.0, index, 0.0])

    def same(got, want):
        got, want = got.detach().numpy(), np.asarray(want)
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        assert np.isnan(got).any() == (index not in (0.0, 1.0))
        ok = ~np.isnan(want)
        np.testing.assert_allclose(got[ok], want[ok], rtol=1e-12)

    same(kernels.axis_gram("coregion", tp, torch.tensor(x), torch.tensor(x[:2])),
         jkernels.axis_gram("coregion", jp, jnp.asarray(x), jnp.asarray(x[:2])))
    same(kernels.axis_kdiag("coregion", tp, torch.tensor(x)),
         jkernels.axis_kdiag("coregion", jp, jnp.asarray(x)))
    same(features.OutputFeature(2).Kuf("coregion", tp, torch.tensor(x)),
         jfeatures.OutputFeature(2).Kuf("coregion", jp, jnp.asarray(x)))
    X = np.stack([np.linspace(0.1, 0.9, 4), x], 1)
    vec = {"mean": np.array([0.3, -1.1]), "noise": np.array([0.02, 0.07])}
    for kinds in (("matern12", "coregion"), ("coregion", "matern12")):
        Xk = X if kinds[1] == "coregion" else X[:, ::-1].copy()
        jspec = jsgpr.SGPRSpec(kinds=kinds, features=(None, None))
        tspec = sgpr.SGPRSpec(kinds=kinds, features=(None, None))
        jv, tv = _both(vec)
        _close(common.mean_fn(tspec, tv, torch.tensor(Xk)),
               jcommon.mean_fn(jspec, jv, jnp.asarray(Xk)), 1e-12)
        _close(common.obs_noise(tspec, tv, torch.tensor(Xk)),
               jcommon.obs_noise(jspec, jv, jnp.asarray(Xk)), 1e-12)


def test_vector_leaves_without_coregion_raise_as_jax():
    """A vector noise or mean on a model without a coregion axis: the same
    ValueError in both packages."""
    for mod, arr in ((jcommon, jnp.asarray), (common, torch.tensor)):
        spec = jsgpr.SGPRSpec(kinds=("matern12",) * 2, features=(None, None))
        for key, what in (("noise", "per-output noise"), ("mean", "per-output mean")):
            fn = mod.obs_noise if key == "noise" else mod.mean_fn
            with pytest.raises(ValueError, match=what):
                fn(spec, {key: arr(np.zeros(2))}, arr(np.zeros((3, 2))))


# --------------------------------------------------------------------------- #
# the ICM models: data, specs and parameters
# --------------------------------------------------------------------------- #

def _icm_data(nd, n, seed):
    """(X, y): nd continuous columns on [0, 1] and the output index last;
    output 1 is 0.7·f + 0.2 with its own noise level, as the JAX package's
    multi-output experiments build it."""
    rng = np.random.default_rng(seed)
    x = rng.random((n, nd))
    task = rng.integers(0, 2, n)
    f = np.sin(5.0 * x[:, 0]) * (np.cos(3.0 * x[:, 1]) if nd == 2 else 1.0)
    y = np.where(task == 0, f + 0.05 * rng.standard_normal(n),
                 0.7 * f + 0.2 + 0.12 * rng.standard_normal(n))
    return np.concatenate([x, task[:, None].astype(np.float64)], 1), y


_CELLS = ((6, 0.0, 1.0), (5, -0.1, 1.1))


def _icm_feats(pkg, nd, R=1):
    return (tuple(pkg.CellIntegralFeature.from_lims(*c) for c in _CELLS[:nd])
            + (pkg.OutputFeature(2, R),))


def _icm_params(nd, kind="matern12", R=1, seed=11):
    rng = np.random.default_rng(seed)
    axes = tuple({"variance": np.asarray(v), "lengthscale": np.asarray(ell)}
                 for v, ell in ((1.1, 0.3), (0.8, 0.45))[:nd])
    return {"axes": axes + (_b_params(2, R, seed),), "noise": np.array([0.02, 0.05]),
            "mean": np.array([0.1, -0.3])}


def _svgp_icm(nd, variational, kind="matern12"):
    kw = dict(kinds=(kind,) * nd + ("coregion",), num_data=500, variational=variational,
              per_output_noise=True, learn_mean=True)
    return (jsvgp.SVGPSpec(features=_icm_feats(jfeatures, nd), **kw),
            svgp.SVGPSpec(features=_icm_feats(features, nd), **kw))


def _svgp_icm_params(jspec, nd, seed=5):
    rng = np.random.default_rng(seed)
    p = _icm_params(nd)
    if jspec.variational == "full":
        m = jspec.num_inducing
        L = np.tril(0.2 * rng.standard_normal((m, m)), -1) + np.diag(rng.uniform(0.5, 1.2, m))
        q = {"mu": 0.3 * rng.standard_normal(m),
             "raw_L": np.asarray(jsvgp.raw_from_chol(jnp.asarray(L)))}
    else:
        q = {"mu": 0.3 * rng.standard_normal(jspec.axis_m)}
        for i, mi in enumerate(jspec.axis_m):
            L = np.tril(0.2 * rng.standard_normal((mi, mi)), -1) + np.diag(
                rng.uniform(0.5, 1.2, mi))
            q[f"raw_L{i + 1}"] = np.asarray(jsvgp.raw_from_chol(jnp.asarray(L)))
    return {**p, "q": q}


def _grid(pkg, nd):
    return tuple(pkg.CellIntegralFeature.from_lims(4, 0.1, 0.9) for _ in range(nd)) + (
        pkg.OutputFeature(2),)


@pytest.mark.parametrize("nd,variational", ((2, "kron"), (1, "kron"), (1, "full")))
def test_icm_svgp_matches_jax(nd, variational):
    """The ICM SVGP with per-output noise and mean (the Kronecker family on
    2 and 1 cell axes plus the output axis, the full family on 1): the
    initial parameters (rtol 1e-12), the minibatch loss (rtol 1e-10) and every gradient
    leaf, W and κ included (rtol 1e-7); the heads cold and from
    ``precompute``: the posterior marginal and full_cov, predictive, q_v
    marginal and full_cov on cells × outputs, q_u and p_v_u (rtol 1e-9);
    ``posterior_grad`` on the coregion axis raises as JAX's does."""
    jspec, tspec = _svgp_icm(nd, variational)
    for g, w in zip(_torch_flat(tspec.init_params(torch.float64, "cpu")),
                    jax.tree.leaves(jspec.init_params(jnp.float64)), strict=True):
        _close(g, w, 1e-12)    # raw_L: log(expm1(1)) one ulp apart
    X, y = _icm_data(nd, 40, 3)
    p_np = _svgp_icm_params(jspec, nd)
    jx, jy, tx, ty = jnp.asarray(X), jnp.asarray(y), torch.tensor(X), torch.tensor(y)
    _check_value_and_grad(lambda p: jsvgp.loss(jspec, p, jx, jy),
                          lambda p: svgp.loss(tspec, p, tx, ty), p_np)
    jp, tp = _both(p_np)
    xs, _ = _icm_data(nd, 9, 8)
    jxs, txs = jnp.asarray(xs), torch.tensor(xs)
    jg, tg = _grid(jfeatures, nd), _grid(features, nd)
    with torch.no_grad():
        state = svgp.precompute(tspec, tp)
        pairs = [(svgp.posterior(tspec, tp, txs), jsvgp.posterior(jspec, jp, jxs)),
                 (svgp.posterior_from_state(tspec, tp, state, txs, full_cov=True),
                  jsvgp.posterior(jspec, jp, jxs, full_cov=True)),
                 (svgp.posterior_predictive(tspec, tp, txs),
                  jsvgp.posterior_predictive(jspec, jp, jxs)),
                 (svgp.q_v(tspec, tp, tg), jsvgp.q_v(jspec, jp, jg)),
                 (svgp.q_v_from_state(tspec, tp, state, tg, full_cov=True),
                  jsvgp.q_v(jspec, jp, jg, full_cov=True)),
                 (svgp.q_u(tspec, tp), jsvgp.q_u(jspec, jp)),
                 (svgp.p_v_u(tspec, tp, tg), jsvgp.p_v_u(jspec, jp, jg)),
                 (svgp.prior(tspec, tp, txs), jsvgp.prior(jspec, jp, jxs))]
    for got, want in pairs:
        _gauss_close(got, want)
    for mod, spec, p, x in ((jsvgp, jspec, jp, jxs), (svgp, tspec, tp, txs)):
        with pytest.raises(ValueError, match="unknown kernel kind"):
            mod.posterior_grad(spec, p, x, nd)


def test_icm_svgp_module_and_fit_match_jax():
    """The ``SVGP`` module carries W, κ and the per-output noise and mean
    as parameters; its loss equals the function's; 4 steps of
    ``fit_minibatch`` on the ICM SVGP train (the loss falls)."""
    _, tspec = _svgp_icm(2, "kron")
    p = _to_torch(_svgp_icm_params(_svgp_icm(2, "kron")[0], 2))
    model = svgp.SVGP(tspec, p, dtype=torch.float64, device="cpu")
    assert model.noise.shape == (2,) and model.mean.shape == (2,)
    assert set(model.axes[2].keys()) == {"w", "kappa"}
    X, y = _icm_data(2, 200, 4)
    tx, ty = torch.tensor(X), torch.tensor(y)
    np.testing.assert_allclose(float(model(tx, ty).detach()),
                               float(svgp.loss(tspec, p, tx, ty)), rtol=1e-12)
    _, hist = train.fit_minibatch(lambda q, xb, yb: svgp.loss(tspec, q, xb, yb), p, tx, ty,
                                  8, 64, learning_rate=0.02)
    assert float(hist["loss"][-3:].mean()) < float(hist["loss"][:3].mean())


def _sgpr_icm(kind="matern12", **kw):
    feats = lambda pkg: (pkg.CellIntegralFeature.from_lims(7, -0.05, 1.05), pkg.OutputFeature(2))
    kw = dict(kinds=(kind, "coregion"), per_output_noise=True, learn_mean=True, **kw)
    return jsgpr.SGPRSpec(features=feats(jfeatures), **kw), sgpr.SGPRSpec(features=feats(features),
                                                                           **kw)


@pytest.mark.parametrize("kind", ("matern12", "matern32"))
def test_icm_sgpr_matches_jax(kind):
    """The ICM collapsed GP with per-output noise and mean: the ELBO (rtol
    1e-10) and its gradient leaves (rtol 1e-7); every head cold and from
    ``precompute`` (posterior marginal and full_cov, predictive, q_v and
    q_dv along the cell axis on cells × outputs, q_u, p_v_u, prior; the
    gradient posterior along the cell axis for Matérn-3/2; the ``SGPR``
    module's posterior, its noise and mean vectors its parameters), rtol
    1e-9."""
    jspec, tspec = _sgpr_icm(kind)
    X, y = _icm_data(1, 50, 6)
    p_np = _icm_params(1)
    jx, jy, tx, ty = jnp.asarray(X), jnp.asarray(y), torch.tensor(X), torch.tensor(y)
    _check_value_and_grad(lambda p: jsgpr.loss(jspec, p, jx, jy),
                          lambda p: sgpr.loss(tspec, p, tx, ty), p_np)
    jp, tp = _both(p_np)
    xs, _ = _icm_data(1, 9, 8)
    jxs, txs = jnp.asarray(xs), torch.tensor(xs)
    jg, tg = _grid(jfeatures, 1), _grid(features, 1)
    with torch.no_grad():
        st = sgpr.precompute(tspec, tp, tx, ty)
        pairs = [(sgpr.posterior(tspec, tp, tx, ty, txs, full_cov=False),
                  jsgpr.posterior(jspec, jp, jx, jy, jxs, full_cov=False)),
                 (sgpr.posterior_from_state(tspec, tp, st, txs, full_cov=True),
                  jsgpr.posterior(jspec, jp, jx, jy, jxs, full_cov=True)),
                 (sgpr.posterior_predictive(tspec, tp, tx, ty, txs),
                  jsgpr.posterior_predictive(jspec, jp, jx, jy, jxs)),
                 (sgpr.q_v(tspec, tp, tx, ty, tg, full_cov=False),
                  jsgpr.q_v(jspec, jp, jx, jy, jg, full_cov=False)),
                 (sgpr.q_v_from_state(tspec, tp, st, tg, full_cov=True),
                  jsgpr.q_v(jspec, jp, jx, jy, jg, full_cov=True)),
                 (sgpr.q_dv_from_state(tspec, tp, st, tg, 0, full_cov=False),
                  jsgpr.q_dv(jspec, jp, jx, jy, jg, 0, full_cov=False)),
                 (sgpr.q_u(tspec, tp, tx, ty), jsgpr.q_u(jspec, jp, jx, jy)),
                 (sgpr.p_v_u(tspec, tp, tx, ty, tg), jsgpr.p_v_u(jspec, jp, jx, jy, jg)),
                 (sgpr.prior(tspec, tp, txs), jsgpr.prior(jspec, jp, jxs))]
        if kind == "matern32":
            pairs.append((sgpr.posterior_grad_from_state(tspec, tp, st, txs, 0),
                          jsgpr.posterior_grad(jspec, jp, jx, jy, jxs, 0)))
        model = vggp_tpu_torch.SGPR(tspec, tx, ty, tp, dtype=torch.float64, device="cpu")
        assert model.noise.shape == (2,) and model.mean.shape == (2,)
        pairs.append((model.posterior(txs), pairs[0][1]))
    for got, want in pairs:
        _gauss_close(got, want)


def test_icm_exact_matches_jax():
    """The ICM exact GP (rank 2 of 2 outputs) with per-output noise and
    mean: ``init_params`` (exactly), the mll (rtol 1e-10) and its gradients
    (rtol 1e-7), the posterior marginal and full_cov, predictive and q_v on
    cells × outputs, and the ``ExactGP`` module's posterior (rtol 1e-9)."""
    kw = dict(kinds=("matern32", "coregion"), n_outputs=2, coregion_rank=2,
              per_output_noise=True, learn_mean=True)
    jspec, tspec = jexact.ExactGPSpec(**kw), exact.ExactGPSpec(**kw)
    for g, w in zip(_torch_flat(tspec.init_params(torch.float64, "cpu")),
                    jax.tree.leaves(jspec.init_params(jnp.float64)), strict=True):
        np.testing.assert_array_equal(g, w)
    X, y = _icm_data(1, 45, 9)
    p_np = {**_icm_params(1, R=2), "axes": ({"variance": np.asarray(1.1),
                                            "lengthscale": np.asarray(0.3)},
                                           _b_params(2, 2, 4))}
    jx, jy, tx, ty = jnp.asarray(X), jnp.asarray(y), torch.tensor(X), torch.tensor(y)
    _check_value_and_grad(lambda p: jexact.loss(jspec, p, jx, jy),
                          lambda p: exact.loss(tspec, p, tx, ty), p_np)
    jp, tp = _both(p_np)
    xs, _ = _icm_data(1, 9, 8)
    jxs, txs = jnp.asarray(xs), torch.tensor(xs)
    jg, tg = _grid(jfeatures, 1), _grid(features, 1)
    with torch.no_grad():
        pairs = [(exact.posterior(tspec, tp, tx, ty, txs, full_cov=False),
                  jexact.posterior(jspec, jp, jx, jy, jxs, full_cov=False)),
                 (exact.posterior_predictive(tspec, tp, tx, ty, txs),
                  jexact.posterior_predictive(jspec, jp, jx, jy, jxs)),
                 (exact.q_v(tspec, tp, tx, ty, tg, full_cov=False),
                  jexact.q_v(jspec, jp, jx, jy, jg, full_cov=False))]
        model = vggp_tpu_torch.ExactGP(tspec, tx, ty, tp, dtype=torch.float64, device="cpu")
        assert set(model.axes[1].keys()) == {"w", "kappa"} and model.noise.shape == (2,)
        pairs.append((model.posterior(txs), pairs[0][1]))
    for got, want in pairs:
        _gauss_close(got, want)


@pytest.mark.parametrize("init", ("non_informative", "informative"))
def test_inits_on_a_coregion_spec_match_jax(init):
    """``non_informative_init`` and ``informative_init`` on an ICM spec
    with per-output noise and mean (ROADMAP queue 3, item 3): only the keys
    an axis has are written (W and κ kept), the noise and the mean keep
    their (P,) shapes; every leaf at rtol 1e-12."""
    jspec, tspec = _sgpr_icm()
    X, y = _icm_data(1, 30, 2)
    jx, jy, tx, ty = jnp.asarray(X), jnp.asarray(y), torch.tensor(X), torch.tensor(y)
    jp0, tp0 = jspec.init_params(jnp.float64), tspec.init_params(torch.float64, "cpu")
    if init == "informative":
        jp, tp = (jtrain.informative_init(jp0, jx, jy, 1.4),
                  train.informative_init(tp0, tx, ty, 1.4))
    else:
        jp, tp = jtrain.non_informative_init(jp0, jx, jy), train.non_informative_init(tp0, tx, ty)
    assert tp["noise"].shape == (2,) and set(tp["axes"][1]) == {"w", "kappa"}
    for g, w in zip(_torch_flat(tp), jax.tree.leaves(jp), strict=True):
        _close(g, w, 1e-12)


def test_icm_fit_history_matches_jax():
    """4 steps of ``train.fit`` on the ICM collapsed GP: the history, with
    ``coregion_bdiag_2`` in place of the coregion axis's σ² and ℓ, and the
    final parameters at rtol 1e-6."""
    jspec, tspec = _sgpr_icm()
    X, y = _icm_data(1, 40, 12)
    jx, jy, tx, ty = jnp.asarray(X), jnp.asarray(y), torch.tensor(X), torch.tensor(y)
    jp0 = jtrain.non_informative_init(jspec.init_params(jnp.float64), jx, jy)
    jfinal, jhist = jtrain.fit(lambda p: jsgpr.loss(jspec, p, jx, jy), jp0, 4, 0.05)
    tp0 = train.non_informative_init(tspec.init_params(torch.float64, "cpu"), tx, ty)
    tfinal, thist = train.fit(lambda p: sgpr.loss(tspec, p, tx, ty), tp0, 4, 0.05)
    assert sorted(thist) == sorted(jhist) and "coregion_bdiag_2" in thist
    for k in jhist:
        _close(thist[k], jhist[k], RTOL_FIT)
    for g, w in zip(_torch_flat(tfinal), jax.tree.leaves(jfinal), strict=True):
        _close(g, w, RTOL_FIT)


@pytest.mark.parametrize("tree", ("icm", "components", "free"))
def test_convert_carries_the_new_leaves(tree):
    """``params_from_jax`` on a JAX tree with this slice's leaves (an ICM
    SVGP's W, κ, per-output noise and mean and Kronecker q; a sum's
    ``components``; the free model's top-level z) gives the same leaves,
    dtypes and shapes, and ``params_to_numpy`` returns them."""
    from vggp_tpu.models import freesvgp as jfree
    from vggp_tpu.models import sum as jsum

    if tree == "icm":
        jp = _svgp_icm(2, "kron")[0].init_params(jnp.float64)
    elif tree == "components":
        comps = (jsgpr.SGPRSpec(kinds=("matern12", "coregion"), features=_icm_feats(jfeatures, 1)),
                 jsgpr.SGPRSpec(kinds=("matern32", "coregion"), features=_icm_feats(jfeatures, 1)))
        jp = jsum.SumSGPRSpec(components=comps, per_output_noise=True,
                              learn_mean=True).init_params(jnp.float64)
    else:
        jp = jfree.FreeSVGPSpec(kinds=("matern12",) * 2, m=7).init_params(jnp.float64)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    for g, w in zip(_torch_flat(tp), jax.tree.leaves(jp), strict=True):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == np.asarray(w).dtype
    back = convert.params_to_numpy(tp)
    for g, w in zip(jax.tree.leaves(back), jax.tree.leaves(jp), strict=True):
        np.testing.assert_array_equal(g, w)
