"""The port's experiment layer (``vggp_tpu_torch.experiments``) against the JAX
package's ``vggp_tpu.experiments``: the shared modules and the notebook
experiments ``univariate`` and ``kronecker``.

*Exact holds* (no JAX compile): ``configs``; the synthetic windows of
``loaders`` (equal arrays); ``misc``'s dicts, metric and calibration rows on
the same float64 inputs (1e-12); ``zoo``'s specs (meshes, z, frequencies
and knots equal); the port's copy of ``torch_oracle`` against the JAX
package's, bitwise, on one small case of each member.

Then ``univariate.run`` and ``kronecker.run(n_side=10, n_grid=5)`` at 5
iterations: the JAX reference runs once per module (a module fixture, x64
on, its data cast to float32 as in production) and the port runs on the
CPU in float32. Each model is held at float32's tolerance, RTOL = 1e-3:
every final loss, history entry and metric-row entry per entry, every q(v)
mean and variance (and the univariate posterior) within RTOL of its largest
magnitude. The largest gap held (printed at the module's end with -s):
1.8e-5 on the CPU.

One member is held otherwise: ``univariate``'s ``svgp`` (ROADMAP queue 3,
item 19). Adam's first step moves every inducing point by ±lr = 0.05, half
the spacing of the zoo's z grid, so neighbours land on each other (0.35 +
0.05 against 0.45 − 0.05) and on data points; from then on its float32
trajectory is set by roundoff (the JAX package's own float32 and float64
runs part by 9% in the final loss after 5 steps). It is held where the
trajectory is still determined, after its first step, at RTOL (the port's
``run(n_iters=1)`` against the JAX package's calls for that member; gaps
4.0e-6 and 6.3e-7 measured), as ``chip_smoke.py``'s phase 20 holds it
(``P20_ROUNDOFF``); at 5 steps its first two history entries at RTOL and
every value finite.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vggp_tpu import features as jfeatures
from vggp_tpu import train as jtrain
from vggp_tpu.experiments import configs as jconfigs
from vggp_tpu.experiments import kronecker as jkronecker
from vggp_tpu.experiments import loaders as jloaders
from vggp_tpu.experiments import misc as jmisc
from vggp_tpu.experiments import torch_oracle as joracle
from vggp_tpu.experiments import univariate as junivariate
from vggp_tpu.experiments import zoo as jzoo
from vggp_tpu.models import common as jcommon
from vggp_tpu.models import sgpr as jsgpr
from vggp_tpu.utils import gen_1d, integrate_1d

from vggp_tpu_torch.experiments import configs, kronecker, loaders, misc, torch_oracle
from vggp_tpu_torch.experiments import gulfstream, northsea, parity, plotting, simtracks
from vggp_tpu_torch.experiments import univariate, zoo
from vggp_tpu_torch.experiments import (evidence, exceedance, multioutput, multiscale, poisson,
                                        spacetime, streaming, velocity)
from vggp_tpu_torch.models.common import Gaussian

RTOL = 1e-3          # float32's tolerance of the port against the JAX package
ITERS = 5


# --------------------------------------------------------------------------- #
# shared comparisons (also imported by the other test_torch_experiments_* files)
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side is small float32 work, run beside other test workers:
    one intra-op thread for the module (the worker's setting restored
    after), so it does not oversubscribe the cores the JAX compiles need."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the largest gap each module's holds measured (printed at its end with -s)
LARGEST_GAP = {"gap": 0.0}


@pytest.fixture(scope="module", autouse=True)
def report_largest_gap(request):
    LARGEST_GAP["gap"] = 0.0
    yield
    print(f"\n{request.module.__name__}: the largest gap held at rtol {RTOL:.0e}: "
          f"{LARGEST_GAP['gap']:.3e}")


def _gap(got, want) -> float:
    """max|got − want| / max|want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def _close_each(got, want, rtol=RTOL):
    """Every entry within rtol of itself (scalars, metric rows, histories)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    gap = float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-300), initial=0.0))
    LARGEST_GAP["gap"] = max(LARGEST_GAP["gap"], gap)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0.0)


def _close_max(got, want, rtol=RTOL):
    """Within rtol of the largest magnitude (q(v) means and variances)."""
    gap = _gap(got, want)
    LARGEST_GAP["gap"] = max(LARGEST_GAP["gap"], gap)
    assert gap <= rtol, gap


def _hold_member(got: dict, want: dict, keys_max=(), keys_each=("metrics",)):
    """A model's record of an experiment: final loss and ``keys_each`` per
    entry, ``keys_max`` by the largest magnitude."""
    _close_each(got["final_loss"], want["final_loss"])
    for k in keys_each:
        _close_each(got[k], want[k])
    for k in keys_max:
        _close_max(got[k], np.asarray(want[k]))


# --------------------------------------------------------------------------- #
# exact holds: configs, loaders, misc, zoo, the oracle
# --------------------------------------------------------------------------- #

def test_configs_equal_the_jax_dictionaries():
    for name in ("EXP_1_TRAIN", "EXP_1_VAL", "EXP_1_TEST"):
        assert getattr(configs, name) == getattr(jconfigs, name), name


@pytest.mark.parametrize("exp", ["EXP_1_TRAIN", "EXP_1_VAL", "EXP_1_TEST"])
def test_loaders_synthetic_windows_equal_the_jax_arrays(exp, tmp_path):
    """The crc32-seeded synthetic window of each experiment dict: its
    observations at two sparsities and its Simpson truth grid, equal."""
    d = getattr(jconfigs, exp)
    got = loaders.load_gulf_stream_data(str(tmp_path), str(tmp_path), d)
    want = jloaders.load_gulf_stream_data(str(tmp_path), str(tmp_path), d)
    assert type(got).__name__ == type(want).__name__ == "SyntheticGulfStream"
    for sparsity in (3, 10):
        for g, w in zip(got.obs_train_data(sparsity), want.obs_train_data(sparsity), strict=True):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w), strict=True)
    np.testing.assert_array_equal(got.grid_ref_data_simpson(d["N_SPLINES"]),
                                  want.grid_ref_data_simpson(d["N_SPLINES"]), strict=True)
    with pytest.raises(FileNotFoundError):
        loaders.load_gulf_stream_data(str(tmp_path), str(tmp_path), d, allow_synthetic=False)


def test_misc_dicts_equal_the_jax_dicts():
    assert misc.make_training_history_dict(7) == jmisc.make_training_history_dict(7)
    assert misc.cross_validation_dict(4) == jmisc.cross_validation_dict(4)


def test_misc_record_history_from_tensors():
    """A port history (tensors) fills the record with the same floats as
    the same numbers in JAX arrays."""
    rng = np.random.default_rng(3)
    hist = {k: rng.random(6).astype(np.float32)
            for k in ("loss", "elbo", "noise", "scale_sigma_1", "lengthscale_1", "lengthscale_2")}
    got = misc.record_history(misc.make_training_history_dict(6),
                              {k: torch.as_tensor(v) for k, v in hist.items()})
    want = jmisc.record_history(jmisc.make_training_history_dict(6),
                                {k: jnp.asarray(v) for k, v in hist.items()})
    assert got == want
    assert got["scale_sigma_2"] == [] and len(got["loss"]) == 6


@pytest.mark.parametrize("train_y", [None, "given"])
def test_misc_metric_and_calibration_rows_match_jax(train_y):
    """On the same float64 inputs: the nb61 row and the calibration row
    within 1e-12 of the JAX package's, from tensors and from numpy."""
    rng = np.random.default_rng(5)
    truth = rng.standard_normal((6, 7))
    mean = truth.reshape(-1) + 0.1 * rng.standard_normal(42)
    var = 0.01 + rng.random(42)
    ty = None if train_y is None else rng.standard_normal(30)
    want = jmisc.evaluation_metric_row(
        truth, jcommon.Gaussian(mean=jnp.asarray(mean), var=jnp.asarray(var)), ty)
    want_cal = jmisc.calibration_row(truth, jcommon.Gaussian(mean=jnp.asarray(mean),
                                                             var=jnp.asarray(var)))
    for g in (Gaussian(mean=torch.as_tensor(mean), var=torch.as_tensor(var)),
              Gaussian(mean=mean, var=var)):
        got = misc.evaluation_metric_row(truth, g, None if ty is None else torch.as_tensor(ty))
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0.0)
        got_cal = misc.calibration_row(torch.as_tensor(truth), g)
        assert list(got_cal) == list(want_cal)
        np.testing.assert_allclose(list(got_cal.values()), list(want_cal.values()),
                                   rtol=1e-12, atol=0.0)


def test_misc_check_tensors_equal_takes_tensors():
    a = np.arange(5.0)
    assert misc.check_tensors_equal(torch.as_tensor(a), a.copy())
    with pytest.raises(AssertionError):
        misc.check_tensors_equal(torch.as_tensor(a), a + 1e-3)
    with pytest.raises(AssertionError):
        misc.check_tensors_equal(a, a[:4])


def _same_feature(got, want):
    assert type(got).__name__ == type(want).__name__
    assert got.m == want.m
    if isinstance(want, jfeatures.PointFeature):
        np.testing.assert_array_equal(got.z_init, want.z_init, strict=True)
    elif isinstance(want, jfeatures.FourierFeature):
        assert (got.n_frequencies, got.a, got.b) == (want.n_frequencies, want.a, want.b)
    elif isinstance(want, jfeatures.SplineRKHSFeature):
        assert ((got.degree, got.n_intervals, got.a, got.b)
                == (want.degree, want.n_intervals, want.a, want.b))
    else:   # B1 knots, cell meshes
        np.testing.assert_array_equal(got.mesh, want.mesh, strict=True)


_ZOOS = {
    "1d": lambda z: z.sgpr_specs_1d(),
    "1d-narrow": lambda z: z.sgpr_specs_1d((0.2, 0.9), 6, 4, 9, 7),
    "1d-matern12": lambda z: z.sgpr_specs_1d_orders("matern12"),
    "1d-matern32": lambda z: z.sgpr_specs_1d_orders("matern32"),
    "1d-matern52": lambda z: z.sgpr_specs_1d_orders("matern52"),
    "2d": lambda z: z.sgpr_specs_2d(),
    "2d-tracks": lambda z: z.sgpr_specs_2d(n_inducing=10, n_frequencies=8, n_knots=20,
                                           n_cells=20),
}


@pytest.mark.parametrize("name", sorted(_ZOOS))
def test_zoo_specs_equal_the_jax_zoo(name):
    got, want = _ZOOS[name](zoo), _ZOOS[name](jzoo)
    assert list(got) == list(want)
    for member in want:
        assert got[member].kinds == want[member].kinds, member
        for g, w in zip(got[member].features, want[member].features, strict=True):
            _same_feature(g, w)
    for ndim in (1, 2):
        assert zoo.exact_spec(ndim).kinds == jzoo.exact_spec(ndim).kinds
    with pytest.raises(ValueError):
        zoo.sgpr_specs_1d_orders("rbf")


@pytest.mark.parametrize("member", parity.ZOO)
def test_torch_oracle_is_the_jax_package_oracle_bitwise(member):
    """The port's copy of ``torch_oracle`` and the JAX package's, one small
    case of each member: the gridded mean and variance, the losses and the
    hyperparameters equal bit for bit."""
    rng = np.random.default_rng(11)
    X = rng.random((60, 2))
    y = np.sin(4 * X[:, 0]) * np.cos(3 * X[:, 1]) + 0.05 * rng.standard_normal(60)
    mesh = np.linspace(0.0, 1.0, 6)
    kw = dict(n_iters=3, lr=0.05, m_svgp=8, n_omegas=3, seed=2)
    (gm, gv), gl, gh = torch_oracle.fit(member, X, y, mesh, 5, **kw)
    (wm, wv), wl, wh = joracle.fit(member, X, y, mesh, 5, **kw)
    np.testing.assert_array_equal(gm, wm, strict=True)
    np.testing.assert_array_equal(gv, wv, strict=True)
    assert gl == wl and gh == wh
    assert torch_oracle.DTYPE == torch.float64


def test_plotting_writes_or_raises_import_error(tmp_path):
    """A plot needs matplotlib: with it the figure is written, without it
    the call raises ImportError (nothing silences it)."""
    grids = {"a": np.arange(9.0).reshape(3, 3), "b": np.ones((3, 3))}
    path = tmp_path / "grids.png"
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError):
            plotting.plot_grid_heatmaps(grids, path=str(path))
        return
    plotting.plot_grid_heatmaps(grids, title="t", path=str(path))
    plotting.plot_model_history({"elbo": [1.0, 2.0], "noise": [0.1, 0.2]},
                                path=str(tmp_path / "hist.png"))
    assert path.exists() and (tmp_path / "hist.png").exists()


@pytest.mark.parametrize("kind", ["matern12", "matern32"])
def test_gram_1d_derivative_at_a_tie_matches_jax(kind):
    """An inducing point exactly on a data point (univariate's point SVGP
    after its first Adam step): ∂k/∂z as ``jnp.abs``'s +1 at 0 gives it,
    not torch.abs's 0 (ROADMAP queue 3, item 20)."""
    from vggp_tpu import kernels as jkernels
    from vggp_tpu_torch import kernels

    z, x = np.array([0.0, 0.5, 0.3]), np.array([0.0, 0.5, 0.7])
    want = jax.grad(lambda q: jkernels.gram_1d(kind, q, jnp.asarray(x), 1.3, 0.27).sum())(
        jnp.asarray(z))
    zt = torch.tensor(z, requires_grad=True)
    kernels.gram_1d(kind, zt, torch.tensor(x), 1.3, 0.27).sum().backward()
    np.testing.assert_allclose(zt.grad.numpy(), np.asarray(want), rtol=1e-12, atol=0.0)
    assert want[0] != 0.0


class _Ran(Exception):
    pass


@pytest.mark.parametrize("module", [univariate, kronecker, simtracks, gulfstream, northsea,
                                    parity, spacetime, poisson, exceedance, streaming,
                                    velocity, evidence, multioutput, multiscale])
def test_cli_defaults_write_under_results_torch(module, monkeypatch):
    """Each CLI's default ``--outdir`` lies under results/torch/ (never the
    JAX package's committed results/<name>), and ``--device`` reaches run()."""
    def fake_run(**kwargs):
        raise _Ran(kwargs)

    monkeypatch.setattr(module, "run", fake_run)
    name = module.__name__.rsplit(".", 1)[1]
    monkeypatch.setattr(sys, "argv", [name, "--device", "cpu"])
    with pytest.raises(_Ran) as ran:
        module.main()
    kwargs = ran.value.args[0]
    assert kwargs["outdir"] == f"results/torch/{name}"
    assert kwargs["device"] == "cpu"


# each run() at its smallest call
_SMALLEST_RUNS = {
    "univariate": lambda: univariate.run(n_iters=1),
    "kronecker": lambda: kronecker.run(n_side=10, n_grid=5, n_iters=1),
    "simtracks": lambda: simtracks.run(n_iters=1, n_grid=8, observation_sparsity=40),
    "gulfstream": lambda: gulfstream.run(n_iters=1),
    "northsea": lambda: northsea.run(n_iters=1, n_grid=8, max_obs=800),
    "parity": lambda: parity.run(n_iters=1),
    "spacetime": lambda: spacetime.run(m_side=8, n_grid=4, n_iters=1, batch_size=512),
    "poisson": lambda: poisson.run(m_side=8, n_grid=4, n_obs=600, n_iters=1, batch_size=256),
    "exceedance": lambda: exceedance.run(m_side=8, n_eval=16, n_obs=600, n_iters=1,
                                         batch_size=256, n_samples=8, n_features=64),
    "streaming": lambda: streaming.run(m_side=6, n_cells=8, n_passes=3, n_tracks=3,
                                       n_per_track=24, n_hyper_iters=1),
    "velocity": lambda: velocity.run(n_iters=1, n_features=8, n_grid=6),
    "evidence": lambda: evidence.run(n_train=60, n_test=80, n_iters=1, n_marg_samples=8),
    "multioutput": lambda: multioutput.run(n_iters=1),
    "multiscale": lambda: multiscale.run(n_iters=1),
}


@pytest.mark.parametrize("name", sorted(_SMALLEST_RUNS))
def test_runs_default_to_cuda(name):
    """A run() with no device names ``cuda``, and raises without a card rather than
    carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        _SMALLEST_RUNS[name]()


# --------------------------------------------------------------------------- #
# univariate (notebooks 1 & 4)
# --------------------------------------------------------------------------- #

def _univariate_svgp_one_step():
    """The univariate ``svgp`` member after one Adam step by the JAX
    package's calls of ``vggp_tpu/experiments/univariate.py:36-80`` (data in
    float32, the zoo's spec, its init and heads)."""
    f = lambda x: np.sin(2 * x) + np.cos(5 * x)
    X, y_clean = gen_1d(f, 0.0, 1.0, 15)
    y = y_clean + 0.05 * np.random.default_rng(0).standard_normal(15)
    Xj, yj = jnp.asarray(X, jnp.float32), jnp.asarray(y, jnp.float32)
    spec = jzoo.sgpr_specs_1d()["svgp"]
    grid = jfeatures.CellIntegralFeature.from_lims(10, 0.0, 1.0)
    truth, _ = integrate_1d(f, grid.mesh)
    p0 = jtrain.non_informative_init(spec.init_params(), Xj, yj)
    p, hist = jtrain.fit(lambda q: jsgpr.loss(spec, q, Xj, yj), p0, 1, 0.05)
    qv, post = jax.jit(lambda q: (
        jsgpr.q_v(spec, q, Xj, yj, (grid,), full_cov=False),
        jsgpr.posterior(spec, q, Xj, yj, jnp.linspace(0.0, 1.0, 200), full_cov=False)))(p)
    return {"final_loss": float(np.asarray(hist["loss"])[-1]),
            "metrics": jmisc.evaluation_metric_row(truth, qv, y),
            "calibration": jmisc.calibration_row(truth, qv),
            "posterior": (np.asarray(post.mean), np.asarray(post.stddev())),
            "history": {k: np.asarray(v) for k, v in hist.items()}}


@pytest.fixture(scope="module")
def univariate_runs():
    want = junivariate.run(n_iters=ITERS)
    got = univariate.run(n_iters=ITERS, device="cpu")
    one_step = univariate.run(n_iters=1, device="cpu")["models"]["svgp"]
    return got, want, (one_step, _univariate_svgp_one_step())


@pytest.mark.parametrize("model", ["exactgp", "svgp", "vffgp", "asvgp", "griddedgp"])
def test_univariate_matches_jax(univariate_runs, model):
    got_all, want_all, _ = univariate_runs
    assert list(got_all["models"]) == list(want_all["models"])
    got, want = got_all["models"][model], want_all["models"][model]
    assert sorted(got) == sorted(want)
    assert sorted(got["history"]) == sorted(want["history"])
    assert np.isfinite(got["steps_per_sec"]) and got["steps_per_sec"] > 0
    assert list(got["calibration"]) == list(want["calibration"])
    if model == "svgp":
        for k in want["history"]:
            _close_each(got["history"][k][:2], np.asarray(want["history"][k])[:2])
        assert all(np.all(np.isfinite(v)) for v in (got["final_loss"], got["metrics"],
                                                    *got["posterior"]))
        return
    _hold_member(got, want)
    for k in want["history"]:
        _close_each(got["history"][k], np.asarray(want["history"][k]))
    for g, w in zip(got["posterior"], want["posterior"], strict=True):
        _close_max(g, np.asarray(w))
    _close_each(list(got["calibration"].values()), list(want["calibration"].values()))
    # max|mean − truth| moves by at most max|Δmean|: held within RTOL of the
    # largest magnitude of the product
    truth = want_all["truth_integrals"]
    assert abs(got["qv_max_err"] - want["qv_max_err"]) <= RTOL * np.abs(truth).max()


def test_univariate_svgp_matches_jax_after_one_step(univariate_runs):
    """The roundoff-set member where its trajectory is still determined."""
    got, want = univariate_runs[2]
    _hold_member(got, want)
    _close_each(list(got["calibration"].values()), list(want["calibration"].values()))
    for g, w in zip(got["posterior"], want["posterior"], strict=True):
        _close_max(g, w)
    for k, v in want["history"].items():
        _close_each(got["history"][k], v)


def test_univariate_truth_and_data_equal_jax(univariate_runs):
    got, want, _ = univariate_runs
    np.testing.assert_array_equal(got["truth_integrals"], want["truth_integrals"], strict=True)
    for g, w in zip(got["data"], want["data"], strict=True):
        np.testing.assert_array_equal(g, w, strict=True)


def test_univariate_run_orders_smoke():
    """The kernel-order × feature-family matrix on the port (its 12 members
    are held against JAX by tests/test_torch_zoo.py)."""
    out = univariate.run_orders(n_iters=2, device="cpu")
    assert list(out) == ["matern12", "matern32", "matern52"]
    for models in out.values():
        assert list(models) == ["svgp", "vffgp", "asvgp", "griddedgp"]
        for m in models.values():
            assert list(m)[:6] == ["mse", "mae", "rmse", "r2", "nlpd", "msll"]
            assert all(np.isfinite(v) for v in m.values())


# --------------------------------------------------------------------------- #
# kronecker (notebooks 3 & 5)
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def kronecker_runs():
    kw = dict(n_side=10, n_grid=5, n_iters=ITERS)
    return kronecker.run(device="cpu", **kw), jkronecker.run(**kw)


@pytest.mark.parametrize("model", ["exactgp", "svgp", "vffgp", "asvgp", "griddedgp"])
def test_kronecker_matches_jax(kronecker_runs, model):
    got_all, want_all = kronecker_runs
    assert list(got_all["models"]) == list(want_all["models"])
    np.testing.assert_array_equal(got_all["truth"], want_all["truth"], strict=True)
    got, want = got_all["models"][model], want_all["models"][model]
    assert sorted(got) == sorted(want)
    assert got["qv_grid"].shape == (5, 5) and got["qv_var"].min() > 0
    _hold_member(got, want, keys_max=("qv_grid", "qv_var"))
    assert abs(got["qv_max_err"] - want["qv_max_err"]) <= RTOL * np.abs(want["qv_grid"]).max()
