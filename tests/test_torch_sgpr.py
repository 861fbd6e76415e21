"""The port's collapsed GP (``vggp_tpu_torch.models.sgpr``), its factored core
in ``models.common`` and the full-batch trainer and init heuristics of
``train`` against the JAX package.

Two configurations, Matérn-1/2 cell features on uniform meshes: 1-D with 32
cells on [0, 1] and 200 points (the README quick start), and 2-D with 16×16
cells and 512 points. Both packages get the same numpy inputs in float64 on
the CPU (JAX in x64, its Pallas kernels in interpret mode). The ELBO is held
at rtol 1e-10, gradient leaves and trajectories at 1e-7 and 1e-6 (as the
SVGP's), heads at rtol 1e-9 with atol 1e-9·max|ref|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vggp_tpu import config as jconfig
from vggp_tpu import train as jtrain
from vggp_tpu.features import CellIntegralFeature as JaxCellFeature
from vggp_tpu.models import sgpr as jsgpr

import vggp_tpu_torch
from vggp_tpu_torch import config, convert, train
from vggp_tpu_torch.features import CellIntegralFeature
from vggp_tpu_torch.models import common, sgpr
from vggp_tpu_torch.ops import cell_kuf as ck

RTOL_HEAD = 1e-9

# (model cells per axis, serving grid of other cells per axis, points)
_CONFIGS = {
    "1d": (((32, 0.0, 1.0),), ((12, -0.1, 0.8),), 200),
    "2d": (((16, 0.0, 1.0), (16, -0.5, 1.5)), ((5, 0.1, 0.9), (6, -0.3, 1.2)), 512),
}
_PARAMS = {"1d": ((1.3, 0.08),), "2d": ((1.3, 0.2), (0.8, 0.3))}


def _specs(name):
    lims = _CONFIGS[name][0]
    kinds = ("matern12",) * len(lims)
    return (jsgpr.SGPRSpec(kinds=kinds, features=tuple(JaxCellFeature.from_lims(*g) for g in lims)),
            sgpr.SGPRSpec(kinds=kinds, features=tuple(CellIntegralFeature.from_lims(*g)
                                                      for g in lims)))


def _grids(name, which):
    lims = _CONFIGS[name][0 if which == "own" else 1]
    return (tuple(JaxCellFeature.from_lims(*g) for g in lims),
            tuple(CellIntegralFeature.from_lims(*g) for g in lims))


def _data(name, seed, n=None):
    rng = np.random.default_rng(seed)
    n = n or _CONFIGS[name][2]
    if name == "1d":
        x = rng.random(n)
        return x, np.sin(6 * x) + 0.05 * rng.standard_normal(n)
    x = np.stack([rng.random(n), rng.random(n) * 2.0 - 0.5], axis=1)
    return x, np.sin(6 * x[:, 0]) * np.cos(3 * x[:, 1]) + 0.1 * rng.standard_normal(n)


def _params_np(name):
    return {"axes": tuple({"variance": np.asarray(v), "lengthscale": np.asarray(ell)}
                          for v, ell in _PARAMS[name]),
            "noise": np.asarray(0.02)}


def _close(got, want, rtol=RTOL_HEAD):
    want, got = (v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
                 for v in (want, got))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())


def _gauss_close(got, want, rtol=RTOL_HEAD):
    _close(got.mean, want.mean, rtol)
    if want.cov is not None:
        assert got.var is None
        _close(got.cov, want.cov, rtol)
    else:
        assert got.cov is None
        _close(got.var, want.var, rtol)


def _torch_flat(tree):
    """Leaves in ``jax.tree.leaves`` order (dict keys sorted); a gradient
    that autograd left as None is a zero."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _torch_flat(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for v in tree for leaf in _torch_flat(v)]
    return [np.zeros(()) if tree is None else tree.detach().numpy()]


def _jax_value_and_grad(loss_fn, p_np):
    raw = jtrain.unconstrain(jax.tree.map(jnp.asarray, p_np))
    val, g = jax.jit(jax.value_and_grad(lambda r: loss_fn(jtrain.constrain(r))))(raw)
    return float(val), [np.asarray(v) for v in jax.tree.leaves(g)]


def _torch_value_and_grad(loss_fn, p_np):
    raw = train.raw_leaves_from(convert.params_from_jax(p_np, device="cpu", dtype=torch.float64))
    val = loss_fn(train.constrain(raw))
    val.backward()
    return float(val.detach()), _torch_flat(train.tree_map(lambda v: v.grad, raw))


# --------------------------------------------------------------------------- #
# the bound, its gradients, the trainer and the inits
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("scalar_whiten", [True, False])
@pytest.mark.parametrize("name", sorted(_CONFIGS))
def test_elbo_and_gradients_match_jax(name, scalar_whiten, monkeypatch):
    """The loss (rtol 1e-10) and every gradient leaf (rtol 1e-7) through the
    scalar-tangent whitening (``cell_kuf_with_dl``, one launch per axis) and,
    with ``SCALAR_WHITEN_VJP`` off on both sides, through autograd of the
    dense Kuu factors."""
    monkeypatch.setattr(jconfig, "SCALAR_WHITEN_VJP", scalar_whiten)
    monkeypatch.setattr(config, "SCALAR_WHITEN_VJP", scalar_whiten)
    jspec, tspec = _specs(name)
    x, y = _data(name, 0)
    p_np = _params_np(name)
    jval, jg = _jax_value_and_grad(lambda p: jsgpr.loss(jspec, p, jnp.asarray(x), jnp.asarray(y)),
                                   p_np)
    calls = []
    real = ck.cell_kuf_with_dl
    monkeypatch.setattr(ck, "cell_kuf_with_dl", lambda *a: calls.append(1) or real(*a))
    tval, tg = _torch_value_and_grad(
        lambda p: sgpr.loss(tspec, p, torch.tensor(x), torch.tensor(y)), p_np)
    assert len(calls) == (len(tspec.kinds) if scalar_whiten else 0)
    np.testing.assert_allclose(tval, jval, rtol=1e-10)
    for g, w in zip(tg, jg, strict=True):
        np.testing.assert_allclose(g, w, rtol=1e-7, atol=1e-7 * max(abs(w).max(), 1e-300))
    assert all(abs(float(g)) > 1e-3 for g in tg)      # every hyperparameter is live


@pytest.mark.parametrize("name", sorted(_CONFIGS))
def test_fit_trajectory_matches_jax(name):
    """``non_informative_init``, then 5 full-batch Adam steps at lr 0.05
    (torch.optim.Adam against optax.adam): every history entry and the final
    parameters at rtol 1e-6."""
    jspec, tspec = _specs(name)
    x, y = _data(name, 1)
    jx, jy, tx, ty = jnp.asarray(x), jnp.asarray(y), torch.tensor(x), torch.tensor(y)
    jp0 = jtrain.non_informative_init(jspec.init_params(jnp.float64), jx, jy)
    jfinal, jhist = jtrain.fit(lambda p: jsgpr.loss(jspec, p, jx, jy), jp0, 5, 0.05)
    tp0 = train.non_informative_init(tspec.init_params(torch.float64, "cpu"), tx, ty)
    tfinal, thist = train.fit(lambda p: sgpr.loss(tspec, p, tx, ty), tp0, 5, 0.05)
    assert sorted(thist) == sorted(jhist)
    for k in jhist:
        assert thist[k].shape == (5,)
        _close(thist[k], jhist[k], 1e-6)
    for g, w in zip(_torch_flat(tfinal), jax.tree.leaves(jfinal), strict=True):
        _close(g, w, 1e-6)
    assert float(thist["loss"][-1]) < float(thist["loss"][0])


def test_fit_trainable_freezes_leaves():
    """``trainable`` False leaves keep their initial values exactly, as the
    JAX package's mask does; the others move."""
    jspec, tspec = _specs("2d")
    x, y = _data("2d", 2)
    tx, ty = torch.tensor(x), torch.tensor(y)
    p0 = convert.params_from_jax(_params_np("2d"), device="cpu", dtype=torch.float64)
    mask = lambda p: {"axes": ({"variance": True, "lengthscale": False},
                               {"variance": True, "lengthscale": True}), "noise": False}
    final, _ = train.fit(lambda p: sgpr.loss(tspec, p, tx, ty), p0, 3, 0.05, trainable=mask)
    assert float(final["axes"][0]["lengthscale"]) == pytest.approx(0.2, rel=1e-12)
    assert float(final["noise"]) == pytest.approx(0.02, rel=1e-12)
    assert abs(float(final["axes"][1]["lengthscale"]) - 0.3) > 1e-3
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    jfinal, _ = jtrain.fit(lambda p: jsgpr.loss(jspec, p, jx, jy),
                           jax.tree.map(jnp.asarray, _params_np("2d")), 3, 0.05,
                           trainable=mask)
    for g, w in zip(_torch_flat(final), jax.tree.leaves(jfinal), strict=True):
        _close(g, w, 1e-6)


@pytest.mark.parametrize("name", sorted(_CONFIGS))
def test_inits_match_jax(name):
    """``non_informative_init`` and ``informative_init`` (population
    moments), rtol 1e-12."""
    jspec, tspec = _specs(name)
    x, y = _data(name, 3)
    jx, jy, tx, ty = jnp.asarray(x), jnp.asarray(y), torch.tensor(x), torch.tensor(y)
    j0, t0 = jspec.init_params(jnp.float64), tspec.init_params(torch.float64, "cpu")
    pairs = [(train.non_informative_init(t0, tx, ty, lmbda=2.0, kappa=3.0),
              jtrain.non_informative_init(j0, jx, jy, lmbda=2.0, kappa=3.0)),
             (train.informative_init(t0, tx, ty, prior_amplitude=1.5, lmbda=0.5),
              jtrain.informative_init(j0, jx, jy, prior_amplitude=1.5, lmbda=0.5)),
             (train.informative_init(t0, tx, ty, prior_amplitude=40.0),    # the noise floor
              jtrain.informative_init(j0, jx, jy, prior_amplitude=40.0))]
    for got, want in pairs:
        for g, w in zip(_torch_flat(got), jax.tree.leaves(want), strict=True):
            _close(g, w, 1e-12)
    assert got["noise"].dtype == torch.float64


def test_nonneg_gradient_matches_jnp_maximum():
    """The trace-gap clamp keeps ``jnp.maximum``'s gradient: 0, ½ at the
    tie, 1."""
    for x0 in (-1.0, 0.0, 2.0):
        t = torch.tensor(x0, dtype=torch.float64, requires_grad=True)
        common.nonneg(t).backward()
        assert float(t.grad) == float(jax.grad(lambda v: jnp.maximum(v, 0.0))(x0))


def test_collapsed_tangent_rides_the_model_precision(monkeypatch):
    """The ℓ-tangent's products take ``config.MATMUL_PRECISION`` (fp32, no
    TF32 on the card), the only precision of the port's gradient products:
    in the collapsed bound, in the SVGP's whitening, and in the fused
    kernel's ``t``."""
    seen, inside = [], []
    real_prec, real_tangent = common.matmul_precision, common._whitened_kuf_tangent

    def tangent(*a):
        inside.append(1)
        try:
            return real_tangent(*a)
        finally:
            inside.pop()

    monkeypatch.setattr(common, "matmul_precision",
                        lambda prec: (seen.append(prec) if inside else None) or real_prec(prec))
    monkeypatch.setattr(common, "_whitened_kuf_tangent", tangent)
    _, tspec = _specs("2d")
    x, y = _data("2d", 4)
    _torch_value_and_grad(lambda p: sgpr.loss(tspec, p, torch.tensor(x), torch.tensor(y)),
                          _params_np("2d"))
    assert seen == [config.MATMUL_PRECISION] * 4
    assert not hasattr(config, "GRAD_MATMUL_PRECISION")
    p = {k: torch.tensor(v, dtype=torch.float64, requires_grad=True)
         for k, v in (("variance", 1.3), ("lengthscale", 0.2))}
    common.whitened_kuf_scalar(tspec.features[0], "matern12", 1e-6, p, torch.tensor(x[:, 0]))
    assert seen == [config.MATMUL_PRECISION] * 6
    # the fused route (forced on at two 128-cell bands), whose t is the kernel's
    fused = []
    real_fused = ck.fused_banded_whiten_kuf
    monkeypatch.setattr(ck, "fused_banded_whiten_kuf",
                        lambda *a: fused.append(a[-2:]) or real_fused(*a))
    monkeypatch.setattr(config, "FUSED_WHITEN_KUF", True)
    p["lengthscale"] = torch.tensor(0.02, dtype=torch.float64, requires_grad=True)
    common.whitened_kuf_scalar(CellIntegralFeature.from_lims(256, 0.0, 1.0), "matern12", 1e-6,
                               p, torch.tensor(x[:, 0]))
    assert fused == [(config.WHITEN_MATMUL_PRECISION, config.MATMUL_PRECISION)]


def test_elbo_builds_no_dense_kuu_factor(monkeypatch):
    """On the scalar-tangent path the bound never factorizes Kuu (its heads
    do); with the dense whitening it must."""
    _, tspec = _specs("2d")
    x, y = _data("2d", 4)
    calls = []
    real = common.axis_chol_kuu
    monkeypatch.setattr(common, "axis_chol_kuu", lambda *a: calls.append(1) or real(*a))
    p = convert.params_from_jax(_params_np("2d"), device="cpu", dtype=torch.float64)
    _torch_value_and_grad(lambda p: sgpr.loss(tspec, p, torch.tensor(x), torch.tensor(y)),
                          _params_np("2d"))
    assert calls == []
    sgpr.precompute(tspec, p, torch.tensor(x), torch.tensor(y))
    assert calls == [1]
    monkeypatch.setattr(config, "SCALAR_WHITEN_VJP", False)
    sgpr.elbo(tspec, p, torch.tensor(x), torch.tensor(y))
    assert calls == [1, 1]


# --------------------------------------------------------------------------- #
# heads
# --------------------------------------------------------------------------- #

_HEADS = ["posterior", "posterior_full", "posterior_predictive", "posterior_from_state",
          "posterior_from_state_full", "prior", "q_u",
          "q_v-own", "q_v_full-own", "q_v-other", "q_v_full-other", "q_v_from_state-other",
          "q_dv0-own", "q_dv0_full-other", "q_dv1-other", "q_dv1_full-own",
          "q_dv0_from_state-other", "p_v_u-own", "p_v_u-other"]


def _run_head(mod, spec, p, X, y, xs, grids, head):
    """One head of ``mod`` (the JAX package's sgpr or the port's)."""
    base, _, grid = head.partition("-")
    full = "_full" in base
    if base.startswith("posterior_from_state"):
        return mod.posterior_from_state(spec, p, mod.precompute(spec, p, X, y), xs,
                                        full_cov=full)
    if base.startswith("posterior"):
        return mod.posterior(spec, p, X, y, xs, full_cov=full,
                             predictive=base == "posterior_predictive")
    if base == "prior":
        return mod.prior(spec, p, xs)
    if base == "q_u":
        return mod.q_u(spec, p, X, y)
    g = grids[grid]
    if base == "p_v_u":
        return mod.p_v_u(spec, p, X, y, g)
    if base == "q_v_from_state":
        return mod.q_v_from_state(spec, p, mod.precompute(spec, p, X, y), g, full_cov=False)
    if base.startswith("q_v"):
        return mod.q_v(spec, p, X, y, g, full_cov=full)
    axis = int(base[4])
    if "from_state" in base:
        return mod.q_dv_from_state(spec, p, mod.precompute(spec, p, X, y), g, axis)
    return mod.q_dv(spec, p, X, y, g, axis, full_cov=full)


def _heads_for(name):
    return [h for h in _HEADS if not (name == "1d" and h.startswith("q_dv1"))]


# The JAX side of each head: the cold ones below, the rest from one
# ``precompute`` state (the JAX package's cold q_v, q_dv and posterior are
# ``*_from_state`` on ``_factored_state`` or the same formulas inline), which
# keeps its compiled program small.
_JAX_COLD = {"posterior", "prior", "q_u", "p_v_u-own", "p_v_u-other", "q_v-own"}


def _jax_key(head):
    """The JAX head a port head is held against."""
    if head in _JAX_COLD:
        return head
    base, _, grid = head.partition("-")
    base = base.replace("posterior_from_state", "posterior").replace("_from_state", "")
    return base + (f"-{grid}" if grid else "")


def _run_jax_head(spec, p, state, xs, grids, key):
    base, _, grid = key.partition("-")
    full = "_full" in base
    if base.startswith("posterior"):
        return jsgpr.posterior_from_state(spec, p, state, xs, full_cov=full,
                                          predictive=base == "posterior_predictive")
    if base.startswith("q_v"):
        return jsgpr.q_v_from_state(spec, p, state, grids[grid], full_cov=full)
    return jsgpr.q_dv_from_state(spec, p, state, grids[grid], int(base[4]), full_cov=full)


@pytest.fixture(scope="module")
def jax_heads():
    """Every JAX head, one compiled program per configuration."""
    out = {}
    for name in _CONFIGS:
        jspec, _ = _specs(name)
        x, y = _data(name, 5)
        xs = _data(name, 6, 40)[0]
        grids = {w: _grids(name, w)[0] for w in ("own", "other")}
        keys = {_jax_key(h) for h in _heads_for(name)}

        def run(p, X, Y, XS):
            state = jsgpr.precompute(jspec, p, X, Y)
            heads = {k: _run_jax_head(jspec, p, state, XS, grids, k) for k in keys - _JAX_COLD}
            heads.update({k: _run_head(jsgpr, jspec, p, X, Y, XS, grids, k) for k in _JAX_COLD})
            return heads

        out[name] = jax.jit(run)(jax.tree.map(jnp.asarray, _params_np(name)),
                                 *(jnp.asarray(a) for a in (x, y, xs)))
    return out


def _torch_args(name):
    x, y = _data(name, 5)
    xs = _data(name, 6, 40)[0]
    p = convert.params_from_jax(_params_np(name), device="cpu", dtype=torch.float64)
    return p, torch.tensor(x), torch.tensor(y), torch.tensor(xs)


@pytest.mark.parametrize("name,head", [(n, h) for n in sorted(_CONFIGS) for h in _heads_for(n)])
def test_heads_match_jax(jax_heads, name, head):
    _, tspec = _specs(name)
    p, X, y, xs = _torch_args(name)
    grids = {w: _grids(name, w)[1] for w in ("own", "other")}
    with torch.no_grad():
        got = _run_head(sgpr, tspec, p, X, y, xs, grids, head)
    _gauss_close(got, jax_heads[name][_jax_key(head)])


@pytest.mark.parametrize("name", sorted(_CONFIGS))
def test_warm_heads_equal_cold(name):
    """Heads from one ``precompute`` state equal the cold heads within 1e-9
    in float64, and the cold posterior taken with gradients on (the state's
    blocks through the scalar-tangent route) equals the served one."""
    _, tspec = _specs(name)
    p, X, y, xs = _torch_args(name)
    own = tspec.features
    with torch.no_grad():
        state = sgpr.precompute(tspec, p, X, y)
        pairs = [(sgpr.posterior_from_state(tspec, p, state, xs, full_cov=True),
                  sgpr.posterior(tspec, p, X, y, xs, full_cov=True)),
                 (sgpr.q_v_from_state(tspec, p, state, own, full_cov=True),
                  sgpr.q_v(tspec, p, X, y, own, full_cov=True)),
                 (sgpr.q_dv_from_state(tspec, p, state, own, 0),
                  sgpr.q_dv(tspec, p, X, y, own, 0, full_cov=False))]
    pg = train.tree_map(lambda v: v.clone().requires_grad_(), p)
    pairs.append((pairs[0][0], sgpr.posterior(tspec, pg, X, y, xs, full_cov=True)))
    for warm, cold in pairs:
        _gauss_close(warm, cold)


def test_sgpr_module_and_convert_round_trip():
    """The module holds the data and the raw tree and computes the
    functional loss and heads; ``convert`` carries the tree without "q"."""
    _, tspec = _specs("2d")
    p_np = _params_np("2d")
    back = convert.params_to_numpy(convert.params_from_jax(p_np, device="cpu"))
    assert sorted(back) == ["axes", "noise"] and isinstance(back["axes"], tuple)
    for g, w in zip(jax.tree.leaves(back), jax.tree.leaves(p_np), strict=True):
        np.testing.assert_array_equal(g, w)
    p, X, y, xs = _torch_args("2d")
    model = vggp_tpu_torch.SGPR(tspec, X, y, p, dtype=torch.float64, device="cpu")
    assert len(list(model.parameters())) == 5
    np.testing.assert_allclose(float(model().detach()), float(sgpr.loss(tspec, p, X, y)),
                               rtol=1e-12)
    with torch.no_grad():
        pairs = [(model.posterior(xs), sgpr.posterior(tspec, p, X, y, xs, full_cov=False)),
                 (model.q_v(), sgpr.q_v(tspec, p, X, y, tspec.features, full_cov=False)),
                 (model.q_dv(axis=1), sgpr.q_dv(tspec, p, X, y, tspec.features, 1, False)),
                 (model.q_u(), sgpr.q_u(tspec, p, X, y))]
        assert len(model.precompute()) == 4
    for got, want in pairs:
        _gauss_close(got, want, 1e-12)


# Cases ported since they were written: each now checks that the port raises
# what the JAX package raises for the same call (a Matérn-1/2 axis in a
# gradient head: ValueError), or gives the value JAX gives.
_RAISES_AS_JAX = ("posterior_grad", "posterior_grad_from_state")


@pytest.mark.parametrize("what", ["eigh_factor", "per_output_noise", "learned_mean",
                                  "coregion", "posterior_grad", "posterior_grad_from_state",
                                  "components_init"])
def test_unported_options_raise(what):
    kinds = ("matern12",) * 2
    if what in _RAISES_AS_JAX:
        for mod, cell, X, y, xs, p_of in (
                (jsgpr, JaxCellFeature, jnp.ones((6, 2)) * 0.3, jnp.ones(6), jnp.ones((3, 2)) * 0.4,
                 lambda spec: spec.init_params()),
                (sgpr, CellIntegralFeature, torch.rand(6, 2), torch.rand(6), torch.rand(3, 2),
                 lambda spec: spec.init_params(device="cpu"))):
            spec = mod.SGPRSpec(kinds=kinds, features=tuple(cell.from_lims(8, 0.0, 1.0)
                                                            for _ in range(2)))
            p = p_of(spec)
            with pytest.raises(ValueError, match="once-differentiable"):
                if what == "posterior_grad":
                    mod.posterior_grad(spec, p, X, y, xs, axis=0)
                else:
                    mod.posterior_grad_from_state(spec, p, mod.precompute(spec, p, X, y), xs,
                                                  axis=0)
        return
    if what == "learned_mean":
        # ported since: a per-output mean vector without a coregion axis
        # raises what the JAX package raises
        for mod, cell, X, y, vec, p_of in (
                (jsgpr, JaxCellFeature, jnp.ones((6, 2)) * 0.3, jnp.ones(6), jnp.zeros(2),
                 lambda spec: spec.init_params()),
                (sgpr, CellIntegralFeature, torch.rand(6, 2), torch.rand(6), torch.zeros(2),
                 lambda spec: spec.init_params(device="cpu"))):
            spec = mod.SGPRSpec(kinds=kinds, features=tuple(cell.from_lims(8, 0.0, 1.0)
                                                            for _ in range(2)), learn_mean=True)
            with pytest.raises(ValueError, match="per-output mean"):
                mod.loss(spec, {**p_of(spec), "mean": vec}, X, y)
        return
    # ported since: per-output noise without a coregion axis raises what the
    # JAX package raises; the clamped-eigh factor, the coregion axis and the
    # init of a sum's component tree give JAX's values
    rng = np.random.default_rng(2)
    X, y = rng.random((12, 2)), rng.random(12)
    jX, jy, tX, ty = jnp.asarray(X), jnp.asarray(y), torch.tensor(X), torch.tensor(y)
    if what == "per_output_noise":
        for mod, cell, p_of in ((jsgpr, JaxCellFeature, lambda spec: spec.init_params()),
                                (sgpr, CellIntegralFeature,
                                 lambda spec: spec.init_params(device="cpu"))):
            spec = mod.SGPRSpec(kinds=kinds, features=tuple(cell.from_lims(8, 0.0, 1.0)
                                                            for _ in range(2)),
                                per_output_noise=True)
            with pytest.raises(ValueError):
                p_of(spec)
        return
    if what == "components_init":
        tree = {"components": tuple({"axes": tuple({"variance": np.asarray(1.0),
                                                     "lengthscale": np.asarray(1.0)}
                                                    for _ in range(2))} for _ in range(2)),
                "noise": np.asarray(0.1), "mean": np.asarray(0.0)}
        want = jtrain.non_informative_init(jax.tree.map(jnp.asarray, tree), jX, jy)
        got = train.non_informative_init(convert.params_from_jax(tree, "cpu"), tX, ty)
        for g, w in zip(jax.tree.leaves(convert.params_to_numpy(got)), jax.tree.leaves(want),
                        strict=True):
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-12)
        return
    from vggp_tpu.features import OutputFeature as JaxOutputFeature

    from vggp_tpu_torch.features import OutputFeature

    if what == "coregion":
        X[:, 1] = rng.integers(0, 2, 12)
        jX, tX = jnp.asarray(X), torch.tensor(X)
        jfeats = (JaxCellFeature.from_lims(8, 0.0, 1.0), JaxOutputFeature(2))
        tfeats = (CellIntegralFeature.from_lims(8, 0.0, 1.0), OutputFeature(2))
        kw = dict(kinds=("matern12", "coregion"))
    else:
        jfeats = tuple(JaxCellFeature.from_lims(8, 0.0, 1.0) for _ in range(2))
        tfeats = tuple(CellIntegralFeature.from_lims(8, 0.0, 1.0) for _ in range(2))
        kw = dict(kinds=kinds, factor_method="eigh")
    jspec, tspec = jsgpr.SGPRSpec(features=jfeats, **kw), sgpr.SGPRSpec(features=tfeats, **kw)
    p_np = jax.tree.map(np.asarray, jspec.init_params(jnp.float64))
    np.testing.assert_allclose(
        float(sgpr.elbo(tspec, convert.params_from_jax(p_np, "cpu"), tX, ty)),
        float(jsgpr.elbo(jspec, jax.tree.map(jnp.asarray, p_np), jX, jy)), rtol=1e-10)
