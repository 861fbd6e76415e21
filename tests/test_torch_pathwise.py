"""The port's Matheron samplers (``models.iterative.pathwise_*``) and
bench.py's CG row against the JAX package.

The samplers are held deterministically, with both packages' prior paths and
ε draws patched to one fixed numpy table (rtol 1e-8, antithetic order
included; the control variate at rtol 1e-12), and statistically against the
port's dense ``sgpr.q_v`` at the bounds of tests/test_iterative.py. The
models and helpers are those of ``test_torch_iterative.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import chip_smoke
from vggp_tpu import features as jf
from vggp_tpu import sampling as jsampling
from vggp_tpu.models import iterative as jit_

from vggp_tpu_torch import convert
from vggp_tpu_torch import features as tf
from vggp_tpu_torch import sampling
from vggp_tpu_torch.models import iterative, sgpr

from test_torch_iterative import _case, _close, _grid, _np, _t


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for torch: the solvers' loops run thousands of
    small ops, which a thread pool contended by the other test workers
    slows many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------- #
# the Matheron samplers, deterministic
# --------------------------------------------------------------------------- #

def _patch_draws(monkeypatch, key, n_draws, d, F, noise_shape, seed):
    """Patch both packages' prior paths and ε draws to one numpy table of
    n_draws rows: the port's in call order, JAX's by the key each vmap lane
    holds (the sampler splits ``key`` into n_draws keys, each into (paths,
    ε)). Returns the table."""
    rng = np.random.default_rng(seed)
    om = rng.standard_t(2.0, size=(n_draws, d, F)) * 4.0
    ph = rng.random((n_draws, F)) * 2 * np.pi
    eps = rng.standard_normal((n_draws,) + noise_shape)
    keys = jax.random.split(key, n_draws)
    k1 = jnp.stack([jax.random.split(k)[0] for k in keys])
    k2 = jnp.stack([jax.random.split(k)[1] for k in keys])

    def amp_of(params, like):
        v = 1.0
        for ax in params["axes"]:
            v = v * ax["variance"]
        return like.sqrt(2.0 * v / F)

    def jax_paths(k, spec, params, n_features):
        j = jnp.argmax(jnp.all(k == k1, axis=-1))
        return jnp.asarray(om)[j], jnp.asarray(ph)[j], amp_of(params, jnp)

    real_normal = jax.random.normal

    def jax_normal(k, shape=(), dtype=float):
        if tuple(shape) != noise_shape:
            return real_normal(k, shape, dtype)
        return jnp.asarray(eps)[jnp.argmax(jnp.all(k == k2, axis=-1))].astype(dtype)

    monkeypatch.setattr(jsampling, "prior_paths", jax_paths)
    monkeypatch.setattr(jax.random, "normal", jax_normal)
    rows = iter(range(n_draws))
    eps_rows = iter(range(n_draws))

    def torch_paths(gen, spec, params, n_features):
        j = next(rows)
        return _t(om[j]), _t(ph[j]), amp_of(params, torch)

    monkeypatch.setattr(sampling, "prior_paths", torch_paths)
    monkeypatch.setattr(sampling, "normal", lambda gen, shape, like: _t(eps[next(eps_rows)]))


@pytest.mark.parametrize("antithetic", [True, False], ids=["antithetic", "plain"])
@pytest.mark.parametrize("name", ["1d kms", "2d matern32 stretched"])
def test_matheron_samples_match_jax(name, antithetic, monkeypatch):
    """pathwise_q_v_samples and pathwise_q_dv_samples (axis 0) from one fixed
    draw table, with their prior functionals: rtol 1e-8, the antithetic
    pairs in JAX's (S/2, 2, g) order. 1-D Matérn-1/2 takes the KMS Kuu and
    Woodbury G solves, the stretched Matérn-3/2 the Jacobi ones."""
    jspec, tspec, p_np, X, y, _ = _case(name)
    S = 4 if antithetic else 3
    n_draws = S // 2 if antithetic else S
    F = 48
    gj, gt = _grid(jspec, jf), _grid(tspec, tf)
    Xa = X if X.shape[1] > 1 else X[:, 0]
    key = jax.random.PRNGKey(5)
    kw = dict(n_samples=S, n_features=F, tol=1e-12, maxiter=4000, kuu_tol=1e-12,
              kuu_maxiter=4000, antithetic=antithetic, return_prior=True)
    pj = jax.tree.map(jnp.asarray, p_np)
    pt = convert.params_from_jax(p_np, device="cpu", dtype=torch.float64)
    for head in ("q_v", "q_dv"):
        _patch_draws(monkeypatch, key, n_draws, X.shape[1], F, (X.shape[0],), seed=13)
        if head == "q_v":
            want = jax.jit(lambda p, X, y: jit_.pathwise_q_v_samples(
                jspec, p, X, y, gj, key, **kw))(pj, jnp.asarray(Xa), jnp.asarray(y))
            got = iterative.pathwise_q_v_samples(tspec, pt, _t(Xa), _t(y), gt,
                                                 torch.Generator(), **kw)
        else:
            want = jax.jit(lambda p, X, y: jit_.pathwise_q_dv_samples(
                jspec, p, X, y, gj, 0, key, **kw))(pj, jnp.asarray(Xa), jnp.asarray(y))
            got = iterative.pathwise_q_dv_samples(tspec, pt, _t(Xa), _t(y), gt, 0,
                                                  torch.Generator(), **kw)
        for g, w in zip(got, want):
            _close(g, w, 1e-8)
        if antithetic:
            s = _np(got[0]).reshape(S // 2, 2, -1)
            mid = _np(iterative.q_v_mean_cg(tspec, pt, _t(Xa), _t(y), gt, tol=1e-12,
                                            maxiter=4000)) if head == "q_v" else None
            if mid is not None:
                _close(s.mean(1), np.broadcast_to(mid, s.mean(1).shape), 1e-7)


@pytest.mark.parametrize("cv", [True, False])
def test_q_v_pathwise_moments_match_jax(cv, monkeypatch):
    """q_v_pathwise's mean, variance and per-cell control variate from one
    fixed (samples, priors) pair: rtol 1e-12."""
    jspec, tspec, p_np, X, y, _ = _case("2d kms mean")
    gj, gt = _grid(jspec, jf), _grid(tspec, tf)
    rng = np.random.default_rng(14)
    g = 25
    priors = rng.standard_normal((16, g)) * 0.3
    samples = priors * rng.random(g) + 0.1 * rng.standard_normal((16, g)) + 0.2
    monkeypatch.setattr(jit_, "pathwise_q_v_samples",
                        lambda *a, **k: (jnp.asarray(samples), jnp.asarray(priors)))
    monkeypatch.setattr(iterative, "pathwise_q_v_samples",
                        lambda *a, **k: (_t(samples), _t(priors)))
    pj = jax.tree.map(jnp.asarray, p_np)
    pt = convert.params_from_jax(p_np, device="cpu", dtype=torch.float64)
    want = jit_.q_v_pathwise(jspec, pj, None, None, gj, None, control_variate=cv)
    got = iterative.q_v_pathwise(tspec, pt, None, None, gt, None, control_variate=cv)
    _close(got.mean, want.mean, 1e-12)
    _close(got.var, want.var, 1e-12)


@pytest.mark.parametrize("ratio", [40.0, 300.0])
def test_float32_draws_within_twice_the_jax_float32_error(ratio, monkeypatch):
    """At large ℓ/δ float32 draws lose digits in both packages (the (ℓ/δ)²
    conditioning of Kuu; at 512² cells and ℓ/δ ≈ 550 the gap grows with the
    G solves' maxiter, tools/torch_cg_probe.py). From one fixed draw table,
    cast to each dtype, the port's float32 draws and their variances stay
    within twice the JAX package's own float32 distance from float64: 2-D
    Matérn-1/2 on 32² cells at 512 points, ℓ/δ outside the JAX package's
    float32 Woodbury window (Jacobi PCG in both)."""
    from vggp_tpu.models import sgpr as jsgpr

    m, n, S, F = 32, 512, 8, 512
    ell = ratio / m
    rng = np.random.default_rng(21)
    X = rng.random((n, 2))
    y = np.sin(6 * X[:, 0]) * np.cos(5 * X[:, 1]) + 0.1 * rng.standard_normal(n)
    om = rng.standard_t(1.0, size=(S // 2, 2, F)) / ell     # matern12: df 2ν = 1
    ph = rng.random((S // 2, F)) * 2 * np.pi
    eps = rng.standard_normal((S // 2, n))
    amp = np.sqrt(2 * 0.911 ** 2 / F)
    key = jax.random.PRNGKey(0)
    k1, k2 = (jnp.stack([jax.random.split(k)[i] for k in jax.random.split(key, S // 2)])
              for i in (0, 1))
    real_normal = jax.random.normal
    lane = lambda k, ks: jnp.argmax(jnp.all(k == ks, axis=-1))

    def jax_run(dt):
        monkeypatch.setattr(jsampling, "prior_paths", lambda k, spec, params, nf: (
            jnp.asarray(om, dt)[lane(k, k1)], jnp.asarray(ph, dt)[lane(k, k1)],
            jnp.asarray(amp, dt)))
        monkeypatch.setattr(jax.random, "normal", lambda k, shape=(), dtype=float: (
            jnp.asarray(eps)[lane(k, k2)].astype(dtype) if tuple(shape) == (n,)
            else real_normal(k, shape, dtype)))
        spec = jsgpr.SGPRSpec(kinds=("matern12",) * 2,
                              features=tuple(jf.CellIntegralFeature.from_lims(m, 0.0, 1.0)
                                             for _ in range(2)))
        c = lambda a: jnp.asarray(a, dt)
        p = {"axes": tuple({"variance": c(0.911), "lengthscale": c(ell)} for _ in range(2)),
             "noise": c(0.114)}
        return np.asarray(jax.jit(lambda p, X, y: jit_.pathwise_q_v_samples(
            spec, p, X, y, spec.features, key, n_samples=S, n_features=F,
            antithetic=True))(p, c(X), c(y)), np.float64)

    def port_run(dt):
        rows, eps_rows = iter(range(S // 2)), iter(range(S // 2))
        c = lambda a: torch.as_tensor(a, dtype=dt)
        monkeypatch.setattr(sampling, "prior_paths", lambda gen, spec, params, nf: (
            lambda j: (c(om[j]), c(ph[j]), c(amp)))(next(rows)))
        monkeypatch.setattr(sampling, "normal", lambda gen, shape, like: c(eps[next(eps_rows)]))
        spec = sgpr.SGPRSpec(kinds=("matern12",) * 2,
                             features=tuple(tf.CellIntegralFeature.from_lims(m, 0.0, 1.0)
                                            for _ in range(2)))
        p = {"axes": tuple({"variance": c(0.911), "lengthscale": c(ell)} for _ in range(2)),
             "noise": c(0.114)}
        return _np(iterative.pathwise_q_v_samples(spec, p, c(X), c(y), spec.features,
                                                  torch.Generator(), n_samples=S,
                                                  n_features=F, antithetic=True).double())

    rel = lambda a, b: float(np.abs(a - b).max() / np.abs(b).max())
    j32, j64 = jax_run(jnp.float32), jax_run(jnp.float64)
    t32, t64 = port_run(torch.float32), port_run(torch.float64)
    _close(t64, j64, 1e-8)
    assert rel(t32, t64) <= 2 * rel(j32, j64)
    assert rel(t32.var(0), t64.var(0)) <= 2 * rel(j32.var(0), j64.var(0))


# --------------------------------------------------------------------------- #
# the samplers, statistically (the JAX tests' bounds, tests/test_iterative.py)
# --------------------------------------------------------------------------- #

def _stat_case(d):
    rng = np.random.default_rng(11 if d == 1 else 12)
    if d == 1:
        X = np.sort(rng.uniform(size=70))
        y = np.sin(6 * X) + 0.1 * rng.standard_normal(70)
        feats = (tf.CellIntegralFeature.from_lims(24, 0.0, 1.0),)
        hyp, noise = ((1.0, 0.2),), 0.05
        grids = (tf.CellIntegralFeature.from_lims(8, 0.0, 1.0),)
    else:
        X = rng.random((80, 2))
        y = np.sin(4 * X[:, 0]) * X[:, 1] + 0.05 * rng.standard_normal(80)
        feats = (tf.CellIntegralFeature.from_lims(10, 0.0, 1.0),
                 tf.CellIntegralFeature.from_lims(9, 0.0, 1.0))
        hyp, noise = ((0.8, 0.3), (1.1, 0.25)), 0.04
        grids = (tf.CellIntegralFeature.from_lims(5, 0.0, 1.0),
                 tf.CellIntegralFeature.from_lims(4, 0.0, 1.0))
    spec = sgpr.SGPRSpec(kinds=("matern12",) * d, features=feats, jitter=1e-12)
    p = {"axes": tuple({"variance": _t(v), "lengthscale": _t(ell)} for v, ell in hyp),
         "noise": _t(noise)}
    return spec, p, _t(X), _t(y), grids


@pytest.mark.parametrize("d,S,mean_sigmas,var_rtol", [(1, 1024, 4.0, 0.2), (2, 768, 5.0, 0.25)])
def test_pathwise_moments_match_the_dense_q_v(d, S, mean_sigmas, var_rtol):
    """Empirical mean and variance of S pathwise draws (4096 features)
    against the port's dense ``sgpr.q_v``: the mean within mean_sigmas MC
    standard errors, the variance within var_rtol (as tests/test_iterative.py)."""
    spec, p, X, y, grids = _stat_case(d)
    want = sgpr.q_v(spec, p, X, y, grids, full_cov=False)
    got = iterative.q_v_pathwise(spec, p, X, y, grids, torch.Generator().manual_seed(d),
                                 n_samples=S, n_features=4096, tol=1e-10, kuu_maxiter=4000)
    w_var = _np(want.var)
    np.testing.assert_allclose(_np(got.mean), _np(want.mean),
                               atol=mean_sigmas * float(np.max(np.sqrt(w_var / S))))
    np.testing.assert_allclose(_np(got.var), w_var, rtol=var_rtol, atol=1e-6 * w_var.max())
    assert np.all(_np(got.var) > 0)


def test_antithetic_mean_is_the_cg_mean():
    """Antithetic pairs mirror the affine update around Kvu·w: the mean of
    S = 4 draws is q_v_mean_cg (rtol 1e-7), and q_dv_pathwise's is
    q_dv_mean_from_w."""
    spec, p, X, y, grids = _stat_case(1)
    want = iterative.q_v_mean_cg(spec, p, X, y, grids, tol=1e-12, maxiter=4000)
    gen = torch.Generator().manual_seed(3)
    kw = dict(n_samples=4, n_features=256, antithetic=True, tol=1e-12, maxiter=4000,
              kuu_maxiter=4000)
    _close(iterative.q_v_pathwise(spec, p, X, y, grids, gen, **kw).mean, want, 1e-7)
    w = iterative.solve_w(spec, p, X, y, tol=1e-12, maxiter=4000)
    _close(iterative.q_dv_pathwise(spec, p, X, y, grids, 0, gen, **kw).mean,
           iterative.q_dv_mean_from_w(spec, p, grids, 0, w), 1e-7)


def test_chunked_sampler_matches_one_batch(monkeypatch):
    """A byte budget that holds 4 columns' intermediate splits the batched
    solves into chunks of 4; each column's iterate is its own."""
    spec, p, X, y, grids = _stat_case(2)
    kw = dict(n_samples=6, n_features=128, antithetic=True, tol=1e-12, maxiter=4000,
              return_prior=True)
    one = iterative.pathwise_q_v_samples(spec, p, X, y, grids,
                                         torch.Generator().manual_seed(4), **kw)
    row_bytes = spec.features[0].m * X.shape[0] * X.element_size()
    monkeypatch.setattr(iterative, "SAMPLER_CHUNK_BYTES", 4 * row_bytes)
    calls = []
    solve = iterative._in_chunks
    monkeypatch.setattr(iterative, "_in_chunks", lambda fn, R, b: solve(
        lambda part: calls.append(part.shape[0]) or fn(part), R, b))
    split = iterative.pathwise_q_v_samples(spec, p, X, y, grids,
                                           torch.Generator().manual_seed(4), **kw)
    assert calls == [3, 4, 2]
    for a, b in zip(one, split):
        _close(b, a, 1e-10)


# --------------------------------------------------------------------------- #
# bench.py's CG row (smoke_cases.cg_case)
# --------------------------------------------------------------------------- #

def test_cg_case_matches_jax_and_the_float32_golden():
    """``chip_smoke.cg_case`` is ``smoke_cases.cg_case``; its float64 value
    is the JAX package's within 1e-9 (and ``chip_smoke.CG_F64_JAX`` is that
    value), its float32 value within bench.py's 5e-3 of the float32 golden;
    chip_smoke's copies of the goldens are bench's."""
    from vggp_tpu.utils.smoke_cases import cg_case

    assert chip_smoke._GOLD_CG_F32 == bench._GOLD_FAMILIES_F32["cg_qv_abs_sum"]
    assert chip_smoke._GOLD_CG_F64 == bench._GOLD_FAMILIES_F64["cg_qv_abs_sum"]
    assert chip_smoke.TOL_CG_F32 == bench._FAMILY_TOL["cg_qv_abs_sum"]
    compute, (pj, xj, yj) = cg_case(jnp.float64)
    want = float(jax.jit(compute)(pj, xj, yj))
    spec, pt, xt, yt, _ = chip_smoke.cg_case(torch.float64, torch.device("cpu"))
    np.testing.assert_array_equal(_np(xt), np.asarray(xj))
    np.testing.assert_array_equal(_np(yt), np.asarray(yj))
    got, info = chip_smoke.cg_value(torch.float64, torch.device("cpu"))
    assert info["preconditioner"] == "kms-woodbury"
    assert abs(got - want) <= chip_smoke.TOL_CG_F64 * abs(want)
    assert abs(chip_smoke.CG_F64_JAX - want) <= chip_smoke.TOL_CG_F64 * abs(want)
    got32, info32 = chip_smoke.cg_value(torch.float32, torch.device("cpu"))
    assert info32["preconditioner"] == "jacobi-pcg"
    assert abs(got32 - chip_smoke._GOLD_CG_F32) <= chip_smoke.TOL_CG_F32 * abs(chip_smoke._GOLD_CG_F32)
