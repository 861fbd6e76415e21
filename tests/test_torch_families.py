"""The sum-of-kernels family of the port against the JAX package, and the
family cases of ``smoke_cases`` against ``bench.py``'s float64 goldens; the
helpers of the other family files (``test_torch_families_additive.py``,
``test_torch_families_free.py``, ``test_torch_eigh.py``).

Both packages get the same numpy inputs, made from a seed, in float64 on the
CPU (JAX in x64). Tolerances as the other port tests': heads at rtol 1e-9
(atol 1e-9·max|ref|), losses at rtol 1e-10, gradient leaves at 1e-7, fits at
1e-6. The JAX side of the heads runs as one jitted program a test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import chip_smoke
from vggp_tpu import features as jfeatures
from vggp_tpu import train as jtrain
from vggp_tpu.models import sgpr as jsgpr
from vggp_tpu.models import sum as jsum

import vggp_tpu_torch
from vggp_tpu_torch import features, train
from vggp_tpu_torch.models import sgpr
from vggp_tpu_torch.models import sum as msum

from test_torch_full import (RTOL_FIT, _check_value_and_grad, _close, _gauss_close, _to_torch,
                             _torch_flat)


def _data(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.random((n, 2))
    y = np.sin(5 * x[:, 0]) * np.cos(3 * x[:, 1]) + 0.3 * x[:, 1] + 0.05 * rng.standard_normal(n)
    return x, y


def _both(p_np):
    return jax.tree.map(jnp.asarray, p_np), _to_torch(p_np)


def _tensors(*arrays):
    return [(jnp.asarray(a), torch.tensor(a)) for a in arrays]


def _grids(pkg, lims=((5, 0.1, 0.9), (4, 0.05, 0.95))):
    return tuple(pkg.CellIntegralFeature.from_lims(*g) for g in lims)


def _heads_close(pairs, jargs):
    """Each port head of ``pairs`` ((the port's Gaussian, fn(*jargs) → the
    JAX package's)) against JAX's, rtol 1e-9; the JAX side as one jitted
    program (op-by-op it compiles every primitive at every shape)."""
    want = jax.jit(lambda *a: [fn(*a) for _, fn in pairs])(*jargs)
    for (got, _), w in zip(pairs, want, strict=True):
        _gauss_close(got, w)


def _check_fit(jloss, tloss, jp0, tp0, trainable=None):
    """4 steps of ``train.fit`` in both packages from the same start: the
    history and the final parameters at rtol 1e-6; returns JAX's final
    parameters as numpy."""
    jfinal, jhist = jtrain.fit(jloss, jp0, 4, 0.05,
                               trainable=None if trainable is None else trainable[0])
    tfinal, thist = train.fit(tloss, tp0, 4, 0.05,
                              trainable=None if trainable is None else trainable[1])
    assert sorted(thist) == sorted(jhist)
    for k in jhist:
        _close(thist[k], jhist[k], RTOL_FIT)
    for g, w in zip(_torch_flat(tfinal), jax.tree.leaves(jfinal), strict=True):
        _close(g, w, RTOL_FIT)
    return tfinal, jfinal


# --------------------------------------------------------------------------- #
# the sum of separable kernels
# --------------------------------------------------------------------------- #

def _sum_specs(case):
    """"multiscale": a coarse and a fine Matérn-3/2 cell component on 2-D
    inputs; "lmc": two (Matérn-1/2 cells × coregion) components, the full
    LMC model, with a noise level and a mean per output."""
    def comps(pkg, mod):
        if case == "multiscale":
            return (mod.SGPRSpec(kinds=("matern32",) * 2, features=_grids(pkg, ((3, 0, 1),) * 2)),
                    mod.SGPRSpec(kinds=("matern32",) * 2,
                                 features=_grids(pkg, ((6, -0.05, 1.05), (5, 0, 1)))))
        return tuple(mod.SGPRSpec(kinds=(kind, "coregion"),
                                  features=(pkg.CellIntegralFeature.from_lims(m, 0, 1),
                                            pkg.OutputFeature(2, 1)))
                     for kind, m in (("matern12", 4), ("matern32", 7)))
    kw = dict(per_output_noise=True, learn_mean=True) if case == "lmc" else {}
    return (jsum.SumSGPRSpec(components=comps(jfeatures, jsgpr), **kw),
            msum.SumSGPRSpec(components=comps(features, sgpr), **kw))


def _sum_case(case):
    x, y = _data(60, 3)
    rng = np.random.default_rng(8)
    if case == "lmc":
        task = rng.integers(0, 2, 60)
        x = np.stack([x[:, 0], task.astype(np.float64)], 1)
        y = np.where(task == 0, y, 0.7 * y + 0.2)
        comps = tuple({"axes": ({"variance": np.asarray(v), "lengthscale": np.asarray(ell)},
                                {"w": rng.standard_normal((2, 1)),
                                 "kappa": rng.uniform(0.1, 0.8, 2)})}
                      for v, ell in ((0.9, 0.4), (0.3, 0.15)))
        p = {"components": comps, "noise": np.array([0.02, 0.05]), "mean": np.array([0.1, -0.2])}
    else:
        comps = tuple({"axes": tuple({"variance": np.asarray(v), "lengthscale": np.asarray(ell)}
                                     for _ in range(2))} for v, ell in ((0.8, 0.6), (0.2, 0.15)))
        p = {"components": comps, "noise": np.asarray(0.03)}
    return x, y, p


@pytest.mark.parametrize("case", ("multiscale", "lmc"))
def test_sum_matches_jax(case):
    """The sum of kernels: ``init_params`` (rtol 1e-12), the ELBO (rtol
    1e-10) and its gradient leaves (rtol 1e-7); every head cold and from
    ``precompute`` (the posterior marginal, full_cov and predictive, prior,
    q_u, q_v marginal and full_cov, p_v_u, q_dv, the gradient posterior for
    the Matérn-3/2 sum, each component's posterior, marginal for one and
    full_cov for the other), rtol 1e-9."""
    jspec, tspec = _sum_specs(case)
    for g, w in zip(_torch_flat(tspec.init_params(torch.float64, "cpu")),
                    jax.tree.leaves(jspec.init_params(jnp.float64)), strict=True):
        _close(g, w, 1e-12)
    x, y, p_np = _sum_case(case)
    (jx, tx), (jy, ty) = _tensors(x, y)
    _check_value_and_grad(lambda p: jsum.loss(jspec, p, jx, jy),
                          lambda p: msum.loss(tspec, p, tx, ty), p_np)
    jp, tp = _both(p_np)
    xs = _data(9, 11)[0] if case == "multiscale" else np.stack(
        [np.linspace(0.05, 0.95, 9), np.arange(9) % 2.0], 1)
    (jxs, txs), = _tensors(xs)
    if case == "multiscale":
        jg, tg = _grids(jfeatures), _grids(features)
    else:
        jg = (jfeatures.CellIntegralFeature.from_lims(5, 0.1, 0.9), jfeatures.OutputFeature(2))
        tg = (features.CellIntegralFeature.from_lims(5, 0.1, 0.9), features.OutputFeature(2))
    with torch.no_grad():
        st = msum.precompute(tspec, tp, tx, ty)
        pairs = [(msum.posterior(tspec, tp, tx, ty, txs),
                  lambda p, X, y, xs: jsum.posterior(jspec, p, X, y, xs)),
                 (msum.posterior_from_state(tspec, tp, st, txs, full_cov=True),
                  lambda p, X, y, xs: jsum.posterior_from_state(
                      jspec, p, jsum.precompute(jspec, p, X, y), xs, full_cov=True)),
                 (msum.posterior_predictive(tspec, tp, tx, ty, txs),
                  lambda p, X, y, xs: jsum.posterior_predictive(jspec, p, X, y, xs)),
                 (msum.prior(tspec, tp, txs), lambda p, X, y, xs: jsum.prior(jspec, p, xs)),
                 (msum.q_u(tspec, tp, tx, ty), lambda p, X, y, xs: jsum.q_u(jspec, p, X, y)),
                 (msum.q_v(tspec, tp, tx, ty, tg), lambda p, X, y, xs: jsum.q_v(jspec, p, X, y, jg)),
                 (msum.q_v_from_state(tspec, tp, st, tg, full_cov=True),
                  lambda p, X, y, xs: jsum.q_v(jspec, p, X, y, jg, full_cov=True)),
                 (msum.p_v_u(tspec, tp, tx, ty, tg),
                  lambda p, X, y, xs: jsum.p_v_u(jspec, p, X, y, jg)),
                 (msum.q_dv(tspec, tp, tx, ty, tg, 0),
                  lambda p, X, y, xs: jsum.q_dv(jspec, p, X, y, jg, 0))]
        for q, full in ((0, False), (1, True)):
            pairs.append((msum.component_posterior(tspec, tp, st, txs, q, full_cov=full),
                          lambda p, X, y, xs, q=q, full=full: jsum.component_posterior(
                              jspec, p, jsum.precompute(jspec, p, X, y), xs, q, full)))
        if case == "multiscale":
            pairs.append((msum.posterior_grad(tspec, tp, tx, ty, txs, 1, full_cov=True),
                          lambda p, X, y, xs: jsum.posterior_grad(jspec, p, X, y, xs, 1,
                                                                  full_cov=True)))
    _heads_close(pairs, (jp, jx, jy, jxs))


def test_sum_fit_with_a_frozen_lengthscale_matches_jax():
    """``non_informative_init`` on component trees and 4 steps of
    ``train.fit`` with the coarse component's lengthscales frozen
    (``trainable``): the history (loss, ELBO and noise: no per-axis traces
    for component trees) and the final parameters at rtol 1e-6; the frozen
    leaves keep their values exactly. The ``SumSGPR`` module's loss and
    ``component_posterior`` equal the functions'."""
    jspec, tspec = _sum_specs("multiscale")
    x, y = _data(50, 5)
    (jx, tx), (jy, ty) = _tensors(x, y)
    jp0 = jtrain.non_informative_init(jspec.init_params(jnp.float64), jx, jy)
    tp0 = train.non_informative_init(tspec.init_params(torch.float64, "cpu"), tx, ty)
    for g, w in zip(_torch_flat(tp0), jax.tree.leaves(jp0), strict=True):
        _close(g, w, 1e-12)

    def mask(p, true):
        comps = tuple({"axes": tuple({"variance": true, "lengthscale": q > 0 or not true}
                                     for _ in cp["axes"])} for q, cp in enumerate(p["components"]))
        return {"components": comps, "noise": true}

    tfinal, _ = _check_fit(lambda p: jsum.loss(jspec, p, jx, jy),
                           lambda p: msum.loss(tspec, p, tx, ty), jp0, tp0,
                           (lambda p: mask(p, True), lambda p: mask(p, True)))
    for ax0, ax in zip(tp0["components"][0]["axes"], tfinal["components"][0]["axes"]):
        assert float(ax["lengthscale"]) == float(ax0["lengthscale"])
    model = vggp_tpu_torch.SumSGPR(tspec, tx, ty, tfinal, dtype=torch.float64, device="cpu")
    assert len(model.components) == 2 and len(list(model.parameters())) == 9
    np.testing.assert_allclose(float(model().detach()), float(msum.loss(tspec, tfinal, tx, ty)),
                               rtol=1e-12)
    xs = torch.tensor(_data(5, 2)[0])
    with torch.no_grad():
        _gauss_close(model.component_posterior(xs, 1),
                     msum.component_posterior(tspec, tfinal, msum.precompute(tspec, tfinal, tx, ty),
                                              xs, 1))


def test_sum_spec_validation_raises_as_jax():
    """An empty sum, components of different ndim, and a coregion axis at
    different positions: the same ValueError in both packages."""
    for pkg, mod, smod in ((jfeatures, jsgpr, jsum), (features, sgpr, msum)):
        cell = pkg.CellIntegralFeature.from_lims(3, 0, 1)
        a = mod.SGPRSpec(kinds=("matern12", "coregion"), features=(cell, pkg.OutputFeature(2)))
        b = mod.SGPRSpec(kinds=("coregion", "matern12"), features=(pkg.OutputFeature(2), cell))
        c = mod.SGPRSpec(kinds=("matern12",), features=(cell,))
        with pytest.raises(ValueError, match="non-empty"):
            smod.SumSGPRSpec(components=())
        with pytest.raises(ValueError, match="share ndim"):
            smod.SumSGPRSpec(components=(a, c))
        with pytest.raises(ValueError, match="same position"):
            smod.SumSGPRSpec(components=(a, b))


# --------------------------------------------------------------------------- #
# the family cases of smoke_cases against bench.py's goldens
# --------------------------------------------------------------------------- #

def test_family_cases_match_the_float64_goldens():
    """The coregion, sum and additive cases of ``smoke_cases`` as
    ``chip_smoke`` carries them (its inputs, specs and parameters), in
    float64 on the CPU: every row within rtol 1e-9 of ``bench.py``'s
    float64 golden; ``chip_smoke``'s copies of the goldens are bench's."""
    for name in ("_GOLD_FAMILIES_F64", "_GOLD_FAMILIES_F32"):
        theirs, ours = getattr(bench, name), getattr(chip_smoke, name)
        assert ours == {k: theirs[k] for k in ours}
    got = chip_smoke.family_values(torch.float64, torch.device("cpu"))
    assert sorted(got) == sorted(chip_smoke._GOLD_FAMILIES_F64)
    for name, gold in chip_smoke._GOLD_FAMILIES_F64.items():
        np.testing.assert_allclose(got[name], gold, rtol=1e-9, err_msg=name)


def test_family_case_inputs_match_smoke_cases():
    """``chip_smoke.family_inputs`` and ``family_params`` give the arrays of
    ``smoke_cases.family_inputs`` and ``family_params``, exactly, in float32
    and float64."""
    from vggp_tpu.utils import smoke_cases

    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.float64, torch.float64)):
        got = chip_smoke.family_inputs(tdt, torch.device("cpu"))
        for g, w in zip(got, smoke_cases.family_inputs(jdt), strict=True):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        spec_mo = chip_smoke.family_specs()[0]
        jspec_mo = smoke_cases.family_specs()[0]
        tp = chip_smoke.family_params(spec_mo, tdt, torch.device("cpu"))
        jpp = smoke_cases.family_params(jspec_mo, jdt)[:3]
        for g, w in zip(_torch_flat(list(tp)), jax.tree.leaves(list(jpp)), strict=True):
            np.testing.assert_array_equal(g, w)
