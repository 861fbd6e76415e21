"""The port's ``hyperpost`` (``vggp_tpu/hyperpost.py``) against the JAX
package.

The first nine tests mirror ``tests/test_hyperpost.py`` on the port, with
its bounds and its seeds: every draw the port makes there is the draw JAX
makes at the same key (patched in, in the port's call order), so each
statistical check sees JAX's own sample. A loss exactly quadratic in the
raw space makes the Laplace approximation exact, and an exact GP checks the
semantic contracts (the law of total variance, the shrink to the plug-in
forecast, HMC against Laplace). The quadratic HMC takes 512 draws after
64 warmup steps a chain in place of 4096 after 128 (the port's leapfrog is
a Python loop of one autograd gradient a step; the mean's bound scales
with the draws). The GP's HMC keeps JAX's sizes: its inflation check is a
statement about one sample (at 512 draws it read −4.8e-5, at JAX's 1024
it passes, as in JAX).

The rest hold the port against JAX in float64 on the CPU: the Laplace
mean (in ``ravel_pytree`` order), covariance and log|H| at rtol 1e-10 on
an exact GP and on the 1-D cell GriddedGP (the second-order route through
``CellKufOp``); ``sample_params``, ``predict_marginalized_draws``
(posterior and q_v) and a short HMC (2 chains, 16 warmup, 16 draws) from
one Laplace state (JAX's, through ``convert.laplace_state_from_jax``) and
one numpy draw table, keyed as each JAX function splits its keys; draws,
accept rate and step sizes at rtol 1e-8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from vggp_tpu import hyperpost as jhyper
from vggp_tpu import train as jtrain
from vggp_tpu.features import CellIntegralFeature as JaxCellFeature
from vggp_tpu.models import exact as jexact

from vggp_tpu_torch import convert, hyperpost, sampling, train
from vggp_tpu_torch.features import CellIntegralFeature
from vggp_tpu_torch.models import exact

import test_torch_sgpr as tsg

RTOL = 1e-10
RTOL_DRAWS = 1e-8
RTOL_HEAD = 1e-9


# --------------------------------------------------------------------------- #
# the mirrors of tests/test_hyperpost.py, on JAX's draws
# --------------------------------------------------------------------------- #

def _jax_normals(seed, shape):
    return [np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape, jnp.float64))]


def _jax_hmc_rows(seed, n_chains, n_steps, p):
    """JAX's HMC draws at ``PRNGKey(seed)`` in the port's order: per chain
    w₀ (``k_init``), then per step the momentum (``k_mom``), the ε uniform
    (``k_eps``) and the accept uniform (``k_acc``)."""
    rows = []
    for ck in jax.random.split(jax.random.PRNGKey(seed), n_chains):
        k_init, k = jax.random.split(ck)
        rows.append(np.asarray(jax.random.normal(k_init, (p,), jnp.float64)))
        for _ in range(n_steps):
            k, k_mom, k_acc, k_eps = jax.random.split(k, 4)
            rows += [np.asarray(jax.random.normal(k_mom, (p,), jnp.float64)),
                     np.asarray(jax.random.uniform(k_eps, dtype=jnp.float64)),
                     np.asarray(jax.random.uniform(k_acc, dtype=jnp.float64))]
    return rows


def _use_draws(monkeypatch, rows):
    """The port's draws (normal and uniform) are ``rows``, in call order."""
    it = iter(rows)

    def take(shape, like):
        v = next(it)
        assert v.shape == tuple(shape), (v.shape, shape)
        return torch.as_tensor(v, dtype=like.dtype)

    monkeypatch.setattr(sampling, "normal", lambda gen, shape, like: take(shape, like))
    monkeypatch.setattr(sampling, "uniform", lambda gen, shape, like: take(shape, like))


def _quad_problem():
    """A loss exactly quadratic in the raw space (via unconstrain)."""
    params = {"axes": ({"lengthscale": torch.tensor(0.5, dtype=torch.float64),
                        "variance": torch.tensor(1.2, dtype=torch.float64)},),
              "noise": torch.tensor(0.1, dtype=torch.float64)}
    flat0, unravel = train.ravel(train.unconstrain(params))
    p = flat0.shape[0]
    rng = np.random.default_rng(0)
    Asqrt = rng.standard_normal((p, p)) * 0.4 + np.eye(p)
    A = torch.tensor(Asqrt @ Asqrt.T)
    a = flat0 + 0.05
    c = 1.7

    def loss_fn(q):
        d = train.ravel(train.unconstrain(q))[0] - a
        return 0.5 * d @ (A @ d) + c

    return loss_fn, train.constrain(unravel(a)), A, a, c


def _raws(tree):
    """(S, p) raw draws of a stacked constrained tree, in ravel order."""
    leaves = train.sorted_leaves(train.unconstrain(tree))
    return torch.stack([v.reshape(v.shape[0], -1) for v in leaves], 0).squeeze(-1).T


def test_laplace_exact_on_quadratic_loss():
    loss_fn, opt, A, a, c = _quad_problem()
    st = hyperpost.laplace(loss_fn, opt)
    np.testing.assert_allclose(st.mean.numpy(), a.numpy(), atol=1e-9)
    cov = (st.chol_cov @ st.chol_cov.T).numpy()
    np.testing.assert_allclose(cov, np.linalg.inv(A.numpy()), rtol=1e-8)
    s, logdet = np.linalg.slogdet(A.numpy())
    assert s > 0 and float(st.logdet_h) == pytest.approx(logdet, rel=1e-9)


def test_log_evidence_exact_on_quadratic_loss():
    loss_fn, opt, A, a, c = _quad_problem()
    st = hyperpost.laplace(loss_fn, opt)
    got = float(hyperpost.log_evidence_laplace(loss_fn, opt, st))
    p = st.mean.shape[0]
    want = -c + 0.5 * p * np.log(2 * np.pi) - 0.5 * np.linalg.slogdet(A.numpy())[1]
    assert got == pytest.approx(want, rel=1e-9)


def test_sample_params_moments_match_state(monkeypatch):
    loss_fn, opt, A, a, c = _quad_problem()
    st = hyperpost.laplace(loss_fn, opt)
    _use_draws(monkeypatch, _jax_normals(0, (40_000, 3)))
    draws = hyperpost.sample_params(st, torch.Generator(), 40_000)
    flats = _raws(draws)[::13].numpy()
    cov = (st.chol_cov @ st.chol_cov.T).numpy()
    np.testing.assert_allclose(flats.mean(0), st.mean.numpy(),
                               atol=4 * np.sqrt(cov.max() / flats.shape[0]) + 1e-3)
    np.testing.assert_allclose(np.cov(flats.T), cov, atol=0.05 * cov.max() + 1e-4)


def test_mixture_moments_total_variance_identity():
    rng = np.random.default_rng(1)
    mu = rng.standard_normal((8, 5))
    var = np.exp(rng.standard_normal((8, 5)))
    m, v = hyperpost.mixture_moments(torch.tensor(mu), torch.tensor(var))
    np.testing.assert_allclose(m.numpy(), mu.mean(0), rtol=1e-12)
    np.testing.assert_allclose(v.numpy(), var.mean(0) + mu.var(0), rtol=1e-12)


def _exact_data(n=50, seed=0):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0, 1, n))
    return x, np.sin(6 * x) + 0.1 * rng.standard_normal(n)


def _fit_exact_1d(n=50, seed=0):
    """The port's exact GP (Matérn-3/2) fitted by 400 Adam steps."""
    x, y = _exact_data(n, seed)
    X, Y = torch.tensor(x), torch.tensor(y)
    spec = exact.ExactGPSpec(kinds=("matern32",))
    p0 = train.non_informative_init(spec.init_params(torch.float64, "cpu"), X, Y)
    loss_fn = lambda q: exact.loss(spec, q, X, Y)
    p_fit, _ = train.fit(loss_fn, p0, 400, 0.05)
    return spec, p_fit, loss_fn, X, Y


def test_marginalized_prediction_widens_and_shrinks_to_plugin(monkeypatch):
    spec, p_fit, loss_fn, X, y = _fit_exact_1d()
    st = hyperpost.laplace(loss_fn, p_fit)
    _use_draws(monkeypatch, _jax_normals(2, (256, 3)) + _jax_normals(3, (8, 3)))
    xs = torch.linspace(0.0, 1.0, 31, dtype=torch.float64)
    predict = lambda p: exact.posterior(spec, p, X, y, xs, full_cov=False)
    with torch.no_grad():
        plug = predict(p_fit)
        marg = hyperpost.predict_marginalized(predict, st, torch.Generator(), 256)
        assert torch.all(torch.isfinite(marg.mean))
        assert torch.all(marg.variance() >= 0.95 * plug.variance())
        assert float(torch.mean(marg.variance() - plug.variance())) > 0.0
        st0 = st._replace(chol_cov=torch.zeros_like(st.chol_cov))
        marg0 = hyperpost.predict_marginalized(predict, st0, torch.Generator(), 8)
    np.testing.assert_allclose(marg0.mean.numpy(), plug.mean.numpy(), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(marg0.var.numpy(), plug.variance().numpy(), rtol=1e-5, atol=1e-9)


def test_hmc_exact_on_quadratic_loss(monkeypatch):
    loss_fn, opt, A, a, c = _quad_problem()
    st = hyperpost.laplace(loss_fn, opt)
    _use_draws(monkeypatch, _jax_hmc_rows(0, 4, 64 + 128, 3))
    res = hyperpost.hmc_sample_params(loss_fn, st, torch.Generator(),
                                      n_samples=512, n_chains=4, n_warmup=64)
    assert 0.5 < float(res.accept_rate) <= 1.0
    raws = res.raw_draws.numpy()
    cov_true = np.linalg.inv(A.numpy())
    np.testing.assert_allclose(raws.mean(0), a.numpy(),
                               atol=6 * np.sqrt(cov_true.max() / raws.shape[0]))
    np.testing.assert_allclose(np.cov(raws.T), cov_true, atol=0.15 * cov_true.max())


def test_hmc_marginalized_agrees_with_laplace_on_gp(monkeypatch):
    spec, p_fit, loss_fn, X, y = _fit_exact_1d()
    st = hyperpost.laplace(loss_fn, p_fit)
    xs = torch.linspace(0.0, 1.0, 31, dtype=torch.float64)
    predict = lambda p: exact.posterior(spec, p, X, y, xs, full_cov=False)
    _use_draws(monkeypatch, _jax_hmc_rows(4, 4, 128 + 256, 3) + _jax_normals(7, (4096, 3))
               + _jax_normals(5, (512, 3)))
    res = hyperpost.hmc_sample_params(loss_fn, st, torch.Generator(),
                                      n_samples=1024, n_chains=4, n_warmup=128)
    assert 0.5 < float(res.accept_rate) <= 1.0
    noise_h = train.unconstrain({"noise": res.draws["noise"]})["noise"].numpy()
    noise_l = train.unconstrain({"noise": hyperpost.sample_params(
        st, torch.Generator(), 4096)["noise"]})["noise"].numpy()
    assert noise_h.mean() == pytest.approx(noise_l.mean(), abs=0.2)
    assert noise_h.std() == pytest.approx(noise_l.std(), rel=0.5)
    with torch.no_grad():
        plug = predict(p_fit)
        marg_h = hyperpost.predict_marginalized_draws(predict, res.draws)
        marg_l = hyperpost.predict_marginalized(predict, st, torch.Generator(), 512)
    sd_scale = float(torch.sqrt(torch.mean(plug.variance())))
    np.testing.assert_allclose(marg_h.mean.numpy(), marg_l.mean.numpy(), atol=0.5 * sd_scale)
    assert float(torch.mean(marg_h.variance() - plug.variance())) > 0.0
    assert float(torch.mean(marg_l.variance() - plug.variance())) > 0.0


def test_laplace_hessian_matches_finite_differences():
    spec, p_fit, loss_fn, X, y = _fit_exact_1d(n=30, seed=1)
    st = hyperpost.laplace(loss_fn, p_fit, min_eig_rel=0.0)
    flat, unravel = train.ravel(train.unconstrain(p_fit))
    f = lambda v: float(loss_fn(train.constrain(unravel(torch.tensor(v)))))
    p, h = flat.shape[0], 1e-4
    v0 = flat.numpy()
    H_fd = np.zeros((p, p))
    for i in range(p):
        for j in range(p):
            e_i, e_j = np.eye(p)[i] * h, np.eye(p)[j] * h
            H_fd[i, j] = (f(v0 + e_i + e_j) - f(v0 + e_i - e_j)
                          - f(v0 - e_i + e_j) + f(v0 - e_i - e_j)) / (4 * h * h)
    cov = (st.chol_cov @ st.chol_cov.T).numpy()
    np.testing.assert_allclose(np.linalg.inv(cov), H_fd, rtol=2e-3, atol=1e-4)


def test_laplace_indefinite_hessian_stays_bounded(monkeypatch):
    params = {"axes": ({"lengthscale": torch.tensor(0.5, dtype=torch.float64),
                        "variance": torch.tensor(1.2, dtype=torch.float64)},),
              "noise": torch.tensor(0.1, dtype=torch.float64)}
    flat0, _ = train.ravel(train.unconstrain(params))
    rng = np.random.default_rng(3)
    Q = np.linalg.qr(rng.standard_normal((3, 3)))[0]
    H_ind = torch.tensor(Q @ np.diag([-9.8, 1.6, 4.8]) @ Q.T)

    def loss_fn(q):
        d = train.ravel(train.unconstrain(q))[0] - flat0
        return 0.5 * d @ (H_ind @ d)

    state = hyperpost.laplace(loss_fn, params)
    _use_draws(monkeypatch, _jax_normals(0, (64, 3)) + _jax_normals(1, (32, 3)))
    sd = torch.sqrt(torch.sum(state.chol_cov ** 2, dim=1)).numpy()
    assert np.all(np.isfinite(sd)) and sd.max() < 1.0 / np.sqrt(1.6) + 1e-6
    draws = hyperpost.sample_params(state, torch.Generator(), 64)
    ls = draws["axes"][0]["lengthscale"].numpy()
    assert np.all(np.isfinite(ls)) and ls.max() < 50.0 and ls.min() > 1e-6
    xs = torch.linspace(0, 1, 8, dtype=torch.float64)
    with torch.no_grad():
        g = hyperpost.predict_marginalized(
            lambda p: exact.posterior(exact.ExactGPSpec(kinds=("matern32",)), p, xs, torch.sin(xs),
                                      torch.linspace(0.1, 0.9, 5, dtype=torch.float64),
                                      full_cov=False),
            state, torch.Generator(), 32)
    assert torch.all(torch.isfinite(g.mean)) and torch.all(g.variance() > 0)


# --------------------------------------------------------------------------- #
# the port against JAX
# --------------------------------------------------------------------------- #

def _jax_exact_fit():
    """JAX's exact GP of ``tests/test_hyperpost.py`` fitted there, its
    specs, data and losses in both packages."""
    x, y = _exact_data()
    jX, jY, tX, tY = jnp.asarray(x), jnp.asarray(y), torch.tensor(x), torch.tensor(y)
    js, ts = jexact.ExactGPSpec(kinds=("matern32",)), exact.ExactGPSpec(kinds=("matern32",))
    jloss = lambda q: jexact.loss(js, q, jX, jY)
    p0 = jtrain.non_informative_init(js.init_params(jnp.float64), jX, jY)
    p_fit, _ = jtrain.fit(jloss, p0, 400, 0.05)
    return dict(p=jax.tree.map(np.asarray, p_fit), jloss=jloss,
                tloss=lambda q: exact.loss(ts, q, tX, tY), js=js, ts=ts,
                jX=jX, jY=jY, tX=tX, tY=tY)


def _jax_laplace(loss_fn, p_np):
    """JAX's (mean, chol_cov, logdet_h) as one jitted program."""
    return jax.jit(lambda p: tuple(jhyper.laplace(loss_fn, p)[:3]))(
        jax.tree.map(jnp.asarray, p_np))


def _state_close(got, want, rtol=RTOL):
    mean, chol_cov, logdet_h = (np.asarray(v) for v in want)
    np.testing.assert_allclose(got.mean.numpy(), mean, rtol=rtol, atol=0)
    cg, cw = (got.chol_cov @ got.chol_cov.T).numpy(), chol_cov @ chol_cov.T
    np.testing.assert_allclose(cg, cw, rtol=rtol, atol=rtol * np.abs(cw).max())
    assert float(got.logdet_h) == pytest.approx(float(logdet_h), rel=rtol)


def test_laplace_matches_jax_on_an_exact_gp():
    c = _jax_exact_fit()
    want = _jax_laplace(c["jloss"], c["p"])
    got = hyperpost.laplace(c["tloss"], convert.params_from_jax(c["p"], "cpu", torch.float64))
    _state_close(got, want)
    ev = hyperpost.log_evidence_laplace(c["tloss"],
                                        convert.params_from_jax(c["p"], "cpu", torch.float64), got)
    jstate = jhyper.LaplaceState(*want, unravel=None)
    assert float(ev) == pytest.approx(float(jhyper.log_evidence_laplace(
        c["jloss"], jax.tree.map(jnp.asarray, c["p"]), jstate)), rel=RTOL)


def test_laplace_matches_jax_through_the_cell_kernel_route():
    """The 1-D GriddedGP (32 Matérn-1/2 cells, ROADMAP queue 3, item 16's
    case): the state through ``second_order()``'s route equals JAX's."""
    (js, ts), (x, y) = tsg._specs("1d"), tsg._data("1d", 0)
    p = tsg._params_np("1d")
    from vggp_tpu.models import sgpr as jsgpr
    from vggp_tpu_torch.models import sgpr
    want = _jax_laplace(lambda q: jsgpr.loss(js, q, jnp.asarray(x), jnp.asarray(y)), p)
    got = hyperpost.laplace(lambda q: sgpr.loss(ts, q, torch.tensor(x), torch.tensor(y)),
                            convert.params_from_jax(p, "cpu", torch.float64))
    _state_close(got, want)


def _key_table(keys, values):
    """A traced lookup: the value whose key row equals ``k``."""
    K, V = jnp.asarray(np.stack(keys)), jnp.asarray(np.stack(values))
    return lambda k: V[jnp.argmax(jnp.all(k == K, axis=-1))]


def test_sample_params_and_marginalized_heads_match_jax(monkeypatch):
    """``sample_params`` from one (S, p) table and one Laplace state (JAX's):
    the draws at rtol 1e-8; ``predict_marginalized_draws`` on them, over the
    posterior at 31 points and q_v on 12 cells, at rtol 1e-9."""
    c = _jax_exact_fit()
    jstate = jhyper.laplace(c["jloss"], jax.tree.map(jnp.asarray, c["p"]))
    tstate = convert.laplace_state_from_jax(
        {k: np.asarray(getattr(jstate, k)) for k in ("mean", "chol_cov", "logdet_h")},
        c["p"], device="cpu", dtype=torch.float64)
    S, p = 12, jstate.mean.shape[0]
    eps = np.random.default_rng(9).standard_normal((S, p))
    key = jax.random.PRNGKey(2)
    look = _key_table([np.asarray(key)], [eps])
    real = jax.random.normal
    monkeypatch.setattr(jax.random, "normal", lambda k, shape=(), dtype=float:
                        look(k).astype(dtype) if tuple(shape) == (S, p) else real(k, shape, dtype))
    monkeypatch.setattr(sampling, "normal",
                        lambda gen, shape, like: torch.as_tensor(eps, dtype=like.dtype))
    jd = jhyper.sample_params(jstate, key, S)
    td = hyperpost.sample_params(tstate, torch.Generator(), S)
    for a, b in zip(train.sorted_leaves(td), jax.tree.leaves(jd), strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL_DRAWS)
    xs = np.linspace(0.0, 1.0, 31)
    jgrid, tgrid = JaxCellFeature.from_lims(12, 0.0, 1.0), CellIntegralFeature.from_lims(12, 0.0, 1.0)
    heads = (
        (lambda q: jexact.posterior(c["js"], q, c["jX"], c["jY"], jnp.asarray(xs), full_cov=False),
         lambda q: exact.posterior(c["ts"], q, c["tX"], c["tY"], torch.tensor(xs), full_cov=False)),
        (lambda q: jexact.q_v(c["js"], q, c["jX"], c["jY"], (jgrid,)),
         lambda q: exact.q_v(c["ts"], q, c["tX"], c["tY"], (tgrid,))))
    for jhead, thead in heads:
        want = jax.jit(lambda d: jhyper.predict_marginalized_draws(jhead, d))(jd)
        with torch.no_grad():
            got = hyperpost.predict_marginalized_draws(thead, td)
        for g, w in ((got.mean, want.mean), (got.var, want.var)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL_HEAD,
                                       atol=RTOL_HEAD * np.abs(np.asarray(w)).max())


def _patch_hmc_draws(monkeypatch, key, n_chains, n_steps, p, seed=11):
    """JAX's HMC splits ``key`` into chain keys, each into (k_init, k_run),
    then each step k → (k, k_mom, k_acc, k_eps); the port draws w₀, then
    each step the momentum, the ε uniform and the accept uniform. Both read
    one numpy table."""
    rng = np.random.default_rng(seed)
    nkeys, nvals, ukeys, uvals, order = [], [], [], [], []
    for ck in jax.random.split(key, n_chains):
        k_init, k = jax.random.split(ck)
        w0 = rng.standard_normal(p)
        nkeys.append(np.asarray(k_init))
        nvals.append(w0)
        order.append(w0)
        for _ in range(n_steps):
            k, k_mom, k_acc, k_eps = jax.random.split(k, 4)
            mom, u_eps, u_acc = rng.standard_normal(p), rng.random(), rng.random()
            nkeys.append(np.asarray(k_mom))
            nvals.append(mom)
            ukeys += [np.asarray(k_eps), np.asarray(k_acc)]
            uvals += [np.asarray(u_eps), np.asarray(u_acc)]
            order += [mom, np.asarray(u_eps), np.asarray(u_acc)]
    nlook, ulook = _key_table(nkeys, nvals), _key_table(ukeys, uvals)
    monkeypatch.setattr(jax.random, "normal",
                        lambda k, shape=(), dtype=float: nlook(k).astype(dtype))
    monkeypatch.setattr(jax.random, "uniform",
                        lambda k, shape=(), dtype=float, minval=0.0, maxval=1.0:
                        ulook(k).astype(dtype))
    rows = iter(order)
    monkeypatch.setattr(sampling, "normal",
                        lambda gen, shape, like: torch.as_tensor(next(rows), dtype=like.dtype))
    monkeypatch.setattr(sampling, "uniform",
                        lambda gen, shape, like: torch.as_tensor(next(rows), dtype=like.dtype))


def test_hmc_matches_jax_on_one_draw_table(monkeypatch):
    """A short HMC (2 chains, 16 warmup, 16 draws, 8 leapfrog steps) on the
    exact GP from JAX's Laplace state and one draw table: the raw and
    constrained draws, the accept rate and each chain's step size at rtol
    1e-8."""
    c = _jax_exact_fit()
    jstate = jhyper.laplace(c["jloss"], jax.tree.map(jnp.asarray, c["p"]))
    tstate = convert.laplace_state_from_jax(
        {k: np.asarray(getattr(jstate, k)) for k in ("mean", "chol_cov", "logdet_h")},
        c["p"], device="cpu", dtype=torch.float64)
    key = jax.random.PRNGKey(4)
    kw = dict(n_samples=32, n_chains=2, n_warmup=16, n_leapfrog=8)
    _patch_hmc_draws(monkeypatch, key, 2, 32, jstate.mean.shape[0])
    want = jhyper.hmc_sample_params(c["jloss"], jstate, key, **kw)
    got = hyperpost.hmc_sample_params(c["tloss"], tstate, torch.Generator(), **kw)
    np.testing.assert_allclose(got.raw_draws.numpy(), np.asarray(want.raw_draws), rtol=RTOL_DRAWS)
    for a, b in zip(train.sorted_leaves(got.draws), jax.tree.leaves(want.draws), strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL_DRAWS)
    assert float(got.accept_rate) == pytest.approx(float(want.accept_rate), rel=RTOL_DRAWS)
    np.testing.assert_allclose(got.step_size.numpy(), np.asarray(want.step_size), rtol=RTOL_DRAWS)
    assert 0.0 < float(got.accept_rate) <= 1.0
    flat, _ = ravel_pytree(jtrain.unconstrain(jax.tree.map(jnp.asarray, c["p"])))
    assert got.raw_draws.shape == (32, flat.shape[0])
