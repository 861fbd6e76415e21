"""The port's streaming assimilation (``vggp_tpu_torch.streaming``) against
the JAX package's ``vggp_tpu/streaming.py``.

Both packages get the same numpy inputs, made from a seed, in float64 on the
CPU (JAX in x64); the JAX side of a test runs as one jitted program. Every
function agrees at rtol 1e-10: ``assimilate`` (scalar, per-point and
per-output noise, a learned mean per output), ``assimilate_scan``,
``assimilate_natgrad`` under each likelihood, ``forget``, ``reanchor``,
``to_q`` and ``to_params`` through ``svgp.posterior`` and ``svgp.q_v``. The
stream also equals the port's own batch state (``sgpr``'s factored form),
a JAX state carries across through ``convert``, and the float32 long-stream
case keeps its prior variance within twice the JAX package's error.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vggp_tpu import features as jf
from vggp_tpu import streaming as jstreaming
from vggp_tpu.models import svgp as jsvgp

from vggp_tpu_torch import convert, streaming
from vggp_tpu_torch import features as tf
from vggp_tpu_torch.models import common, sgpr, svgp

RTOL = 1e-10


def _np(v):
    return v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _close(got, want, rtol=RTOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(np.abs(want).max(), 1e-300))


def _state_close(got, want, rtol=RTOL):
    assert sorted(got) == sorted(want) == ["eta", "lam", "n_seen"]
    for k in want:
        _close(got[k], want[k], rtol)


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _specs(case, n, likelihood="gaussian"):
    """(JAX spec, port spec, numpy params, X, y) of a named case: the 1-D
    Matérn-3/2 cells of tests/test_streaming.py, 2-D cells beside a VFF axis,
    and a coregion spec with a noise level and a mean per output."""
    rng = np.random.default_rng(len(case) + n)
    if case == "1d":
        feats = [lambda pkg: pkg.CellIntegralFeature.from_lims(10, 0.0, 1.0)]
        kinds = ("matern32",)
        X = np.sort(rng.random(n))
        y = np.sin(6 * X) + 0.1 * rng.standard_normal(n)
        if likelihood == "poisson":
            y = rng.poisson(np.exp(1.0 + np.sin(2 * np.pi * X))).astype(float)
        elif likelihood == "bernoulli":
            y = (rng.random(n) < 1.0 / (1.0 + np.exp(-5 * np.sin(2 * np.pi * X)))).astype(float)
        elif likelihood == "student_t":
            y = y + 0.3 * rng.standard_t(3.0, n)
        kw = {}
    elif case == "2d":
        feats = [lambda pkg: pkg.CellIntegralFeature.from_lims(6, 0.0, 1.0),
                 lambda pkg: pkg.FourierFeature(a=0.0, b=1.0, n_frequencies=3)]
        kinds = ("matern12", "matern12")
        X = rng.random((n, 2))
        y = np.sin(5 * X[:, 0]) * np.cos(4 * X[:, 1]) + 0.05 * rng.standard_normal(n)
        kw = {}
    else:
        feats = [lambda pkg: pkg.CellIntegralFeature.from_lims(8, 0.0, 1.0),
                 lambda pkg: pkg.OutputFeature(n_outputs=2)]
        kinds = ("matern32", "coregion")
        x = rng.random(n)
        out = (rng.random(n) < 0.5).astype(float)
        X = np.stack([x, out], axis=1)
        y = np.sin(6 * x) * (1.0 + 0.5 * out) + 0.3 * out + 0.1 * rng.standard_normal(n)
        kw = {"per_output_noise": True, "learn_mean": True}
    jspec = jsvgp.SVGPSpec(kinds=kinds, features=tuple(f(jf) for f in feats), num_data=n,
                           likelihood=likelihood, **kw)
    tspec = svgp.SVGPSpec(kinds=kinds, features=tuple(f(tf) for f in feats), num_data=n,
                          likelihood=likelihood, **kw)
    p = jax.tree.map(np.asarray, jspec.init_params(jnp.float64))
    axes = []
    for ax, kind in zip(p["axes"], kinds):
        ax = dict(ax)
        if kind != "coregion":
            ax["lengthscale"] = np.asarray(0.3)
            ax["variance"] = np.asarray(1.2)
        axes.append(ax)
    p["axes"] = tuple(axes)
    p["noise"] = np.full(np.shape(p["noise"]), 0.05) + (0.03 * np.arange(np.size(p["noise"]))
                                                         ).reshape(np.shape(p["noise"]))
    if "mean" in p:
        p["mean"] = np.array([0.2, -0.1])
    return jspec, tspec, p, X, y


def _both(p):
    return jax.tree.map(jnp.asarray, p), convert.params_from_jax(p, device="cpu",
                                                                 dtype=torch.float64)


def _jstate(spec):
    return jstreaming.init_state(spec, jnp.float64)


def _tstate(spec):
    return streaming.init_state(spec, torch.float64, device="cpu")


@pytest.mark.parametrize("noise", ["scalar", "per point"])
@pytest.mark.parametrize("case", ["1d", "2d", "coregion"])
def test_assimilate_matches_jax(case, noise):
    """Three uneven chunks through ``assimilate`` and four equal ones
    through ``assimilate_scan``, with the default noise (per output for the
    coregion spec) or a per-point noise vector: every state leaf at rtol
    1e-10."""
    n = 96
    jspec, tspec, p, X, y = _specs(case, n)
    jp, tp = _both(p)
    nvec = 0.02 + 0.08 * np.random.default_rng(5).random(n) if noise == "per point" else None

    def jrun(p, X, y, nv):
        s = _jstate(jspec)
        for lo in range(0, n, 40):
            s = jstreaming.assimilate(jspec, p, s, X[lo:lo + 40], y[lo:lo + 40],
                                      noise=None if nv is None else nv[lo:lo + 40])
        chunks = lambda a: None if a is None else a.reshape(4, n // 4, *a.shape[1:])
        s2 = jstreaming.assimilate_scan(jspec, p, _jstate(jspec), chunks(X), chunks(y),
                                        chunks(nv))
        return s, s2

    want, want_scan = jax.jit(jrun)(jp, jnp.asarray(X), jnp.asarray(y),
                                    None if nvec is None else jnp.asarray(nvec))
    s = _tstate(tspec)
    Xt, yt = _t(X), _t(y)
    nt = None if nvec is None else _t(nvec)
    for lo in range(0, n, 40):
        s = streaming.assimilate(tspec, tp, s, Xt[lo:lo + 40], yt[lo:lo + 40],
                                 noise=None if nt is None else nt[lo:lo + 40])
    _state_close(s, want)
    chunks = lambda a: None if a is None else a.reshape(4, n // 4, *a.shape[1:])
    got_scan = streaming.assimilate_scan(tspec, tp, _tstate(tspec), chunks(Xt), chunks(yt),
                                         chunks(nt))
    _state_close(got_scan, want_scan)


@pytest.mark.parametrize("likelihood,clip_h", [("gaussian", False), ("poisson", False),
                                               ("bernoulli", False), ("student_t", True)])
def test_assimilate_natgrad_matches_jax(likelihood, clip_h):
    """Two batches of ``assimilate_natgrad`` (γ = 0.5, 4 inner steps) under
    each likelihood, the Student-t with ``clip_h``; the Gaussian at γ = 1,
    one inner step, which reproduces ``assimilate``. rtol 1e-10."""
    n = 80
    jspec, tspec, p, X, y = _specs("1d", n, likelihood)
    jp, tp = _both(p)
    kw = (dict(gamma=1.0, n_inner=1) if likelihood == "gaussian"
          else dict(gamma=0.5, n_inner=4, clip_h=clip_h))

    def jrun(p, X, y):
        s = _jstate(jspec)
        for lo in (0, 40):
            s = jstreaming.assimilate_natgrad(jspec, p, s, X[lo:lo + 40], y[lo:lo + 40], **kw)
        return s

    want = jax.jit(jrun)(jp, jnp.asarray(X), jnp.asarray(y))
    s = _tstate(tspec)
    for lo in (0, 40):
        s = streaming.assimilate_natgrad(tspec, tp, s, _t(X[lo:lo + 40]), _t(y[lo:lo + 40]),
                                         **kw)
    _state_close(s, want)
    if likelihood == "gaussian":
        exact = streaming.assimilate(tspec, tp, _tstate(tspec), _t(X[:40]), _t(y[:40]))
        exact = streaming.assimilate(tspec, tp, exact, _t(X[40:]), _t(y[40:]))
        _state_close(s, exact, 1e-12)


@pytest.mark.parametrize("case", ["1d", "2d", "coregion"])
def test_forget_reanchor_to_params_match_jax(case):
    """On an assimilated state: ``forget`` at ρ = 0.55, ``reanchor`` to
    ℓ × 1.1 and σ² × 0.9 (the Kronecker T of the 2-D specs), ``to_q`` and
    ``to_params`` through ``svgp.posterior`` (marginal and full_cov) and
    ``svgp.q_v`` on a grid of cells: rtol 1e-10."""
    n = 70
    jspec, tspec, p, X, y = _specs(case, n)
    p_new = dict(p)
    p_new["axes"] = tuple(
        ax if "lengthscale" not in ax else
        {**ax, "lengthscale": ax["lengthscale"] * 1.1, "variance": ax["variance"] * 0.9}
        for ax in p["axes"])
    jp, tp = _both(p)
    jpn, tpn = _both(p_new)
    xs = np.random.default_rng(9).random((13, X.shape[1] if X.ndim == 2 else 1))
    if case == "coregion":
        xs[:, 1] = np.arange(13) % 2
    grids = {"1d": lambda pkg: (pkg.CellIntegralFeature.from_lims(7, 0.0, 1.0),),
             "2d": lambda pkg: (pkg.CellIntegralFeature.from_lims(5, 0.0, 1.0),
                                pkg.CellIntegralFeature.from_lims(4, 0.0, 1.0)),
             "coregion": lambda pkg: (pkg.CellIntegralFeature.from_lims(6, 0.0, 1.0),
                                      pkg.OutputFeature(n_outputs=2))}
    grid = grids[case](jf)

    def jrun(p, pn, X, y, xs):
        s = jstreaming.assimilate(jspec, p, _jstate(jspec), X, y)
        f = jstreaming.forget(s, 0.55)
        r = jstreaming.reanchor(jspec, p, pn, f)
        mu, S = jstreaming.to_q(r)
        pq = jstreaming.to_params(jspec, pn, r)
        post = jsvgp.posterior(jspec, pq, xs, full_cov=False)
        cov = jsvgp.posterior(jspec, pq, xs, full_cov=True).cov
        qv = jsvgp.q_v(jspec, pq, grid, full_cov=False)
        return f, r, mu, S, pq["q"], post.mean, post.var, cov, qv.mean, qv.var

    want = jax.jit(jrun)(jp, jpn, jnp.asarray(X), jnp.asarray(y), jnp.asarray(xs))
    s = streaming.assimilate(tspec, tp, _tstate(tspec), _t(X), _t(y))
    f = streaming.forget(s, 0.55)
    r = streaming.reanchor(tspec, tp, tpn, f)
    mu, S = streaming.to_q(r)
    pq = streaming.to_params(tspec, tpn, r)
    post = svgp.posterior(tspec, pq, _t(xs), full_cov=False)
    cov = svgp.posterior(tspec, pq, _t(xs), full_cov=True).cov
    qv = svgp.q_v(tspec, pq, grids[case](tf), full_cov=False)
    got = (f, r, mu, S, pq["q"], post.mean, post.var, cov, qv.mean, qv.var)
    for g, w in zip(got, want, strict=True):
        if isinstance(w, dict) and "lam" in w:
            _state_close(g, w)
        elif isinstance(w, dict):
            for k in w:
                _close(g[k], w[k])
        else:
            _close(g, w)


@pytest.mark.parametrize("case", ["1d", "2d", "coregion"])
def test_streamed_equals_port_batch_state(case):
    """The stream in ragged chunks equals the port's batch collapsed state
    at the same hyperparameters: Λ = B = I + AAᵀ and η = L_B c of
    ``common.factored_state`` (rtol 1e-9: the batch whitens the cell axes
    through the closed-form F⁻¹, the stream through the Cholesky), and the
    streamed posterior equals ``sgpr.posterior``."""
    n = 90
    _, tspec, p, X, y = _specs(case, n)
    _, tp = _both(p)
    cspec = sgpr.SGPRSpec(kinds=tspec.kinds, features=tspec.features,
                          per_output_noise=tspec.per_output_noise, learn_mean=tspec.learn_mean)
    cp = {k: v for k, v in tp.items() if k != "q"}
    s = _tstate(tspec)
    for lo in range(0, n, 17):
        s = streaming.assimilate(tspec, tp, s, _t(X[lo:lo + 17]), _t(y[lo:lo + 17]))
    _, A, LB, c, _ = common.factored_state(cspec, cp, _t(X), _t(y))
    _close(s["lam"], LB @ LB.T, 1e-9)
    _close(s["eta"], LB @ c, 1e-9)
    assert float(s["n_seen"]) == n
    xs = _t(np.random.default_rng(3).random((11, X.shape[1] if X.ndim == 2 else 1)))
    if case == "coregion":
        xs[:, 1] = torch.arange(11) % 2
    got = svgp.posterior(tspec, streaming.to_params(tspec, tp, s), xs, full_cov=False)
    want = sgpr.posterior(cspec, cp, _t(X), _t(y), xs, full_cov=False)
    _close(got.mean, want.mean, 1e-8)
    _close(got.var, want.var, 1e-8)


def test_check_rejections_match_jax():
    """``_check`` refuses a non-Gaussian likelihood in ``assimilate`` (the
    state itself may be made, for ``assimilate_natgrad``), and the
    Kronecker family everywhere, with JAX's messages."""
    for pkg, sv, st, make in (
            (jf, jsvgp, jstreaming, lambda a: jnp.asarray(a)),
            (tf, svgp, streaming, lambda a: _t(a))):
        g = pkg.CellIntegralFeature.from_lims(6, 0.0, 1.0)
        sp = sv.SVGPSpec(kinds=("matern12",), features=(g,), num_data=10, likelihood="poisson")
        kw = {} if st is jstreaming else {"device": "cpu"}
        dt = jnp.float64 if st is jstreaming else torch.float64
        s = st.init_state(sp, dt, **kw)
        p = sp.init_params(dt, **kw)
        X, y = make(np.linspace(0.1, 0.9, 10)), make(np.ones(10))
        with pytest.raises(ValueError, match="closed-form Gaussian-likelihood update"):
            st.assimilate(sp, p, s, X, y)
        sk = sv.SVGPSpec(kinds=("matern12", "matern12"), features=(g, g), num_data=10,
                         variational="kron")
        with pytest.raises(ValueError, match='use variational="full"'):
            st.init_state(sk, dt, **kw)
        for fn in (lambda: st.assimilate_natgrad(sk, None, None, X, y),
                   lambda: st.to_params(sk, None, None),
                   lambda: st.reanchor(sk, None, None, None)):
            with pytest.raises(ValueError, match="dense whitened precision"):
                fn()


def test_convert_carries_a_jax_state():
    """A JAX stream state (lam, eta, n_seen as numpy) crosses through
    ``convert.params_from_jax`` unchanged, and the port's next chunk and
    handoff on it equal JAX's: rtol 1e-10."""
    n = 80
    jspec, tspec, p, X, y = _specs("2d", n)
    jp, tp = _both(p)
    run = jax.jit(lambda p, X, y: jstreaming.assimilate(jspec, p, _jstate(jspec), X, y))
    js = run(jp, jnp.asarray(X[:40]), jnp.asarray(y[:40]))
    ts = convert.params_from_jax(jax.tree.map(np.asarray, js), device="cpu")
    _state_close(ts, js, 0.0)
    assert all(v.dtype == torch.float64 for v in ts.values())
    nxt = jax.jit(lambda p, s, X, y: jstreaming.to_params(
        jspec, p, jstreaming.assimilate(jspec, p, s, X, y))["q"])
    want = nxt(jp, js, jnp.asarray(X[40:]), jnp.asarray(y[40:]))
    got = streaming.to_params(tspec, tp, streaming.assimilate(
        tspec, tp, ts, _t(X[40:]), _t(y[40:])))["q"]
    for k in want:
        _close(got[k], want[k])


def test_to_q_f32_keeps_prior_variance_on_long_streams():
    """tests/test_streaming.py:393's case in float32 (Λ = I + (1e7/3)vvᵀ,
    the variance along a unit w ⊥ v, 1 exactly): the port's float32 error
    within twice the JAX package's, and the variance above 0.9 (a relative
    jitter gave about 0.11)."""
    rng = np.random.default_rng(22)
    m = 8
    v = rng.standard_normal(m)
    v /= np.linalg.norm(v)
    lam = np.eye(m) + (1e7 / 3.0) * np.outer(v, v)
    w = rng.standard_normal(m)
    w -= v * (v @ w)
    w /= np.linalg.norm(w)
    jS = np.asarray(jax.jit(jstreaming.to_q)(
        {"lam": jnp.asarray(lam, jnp.float32), "eta": jnp.zeros((m,), jnp.float32),
         "n_seen": jnp.asarray(1e6, jnp.float32)})[1], np.float64)
    tS = streaming.to_q({"lam": _t(lam, torch.float32), "eta": torch.zeros(m),
                         "n_seen": torch.tensor(1e6)})[1].double().numpy()
    var_j, var_t = float(w @ jS @ w), float(w @ tS @ w)
    assert var_t > 0.9, var_t
    assert abs(var_t - 1.0) <= 2.0 * abs(var_j - 1.0), (var_t, var_j)
