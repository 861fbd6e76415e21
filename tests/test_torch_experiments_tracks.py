"""The port's track experiments against the JAX package's:
``simtracks.run(n_grid=8, observation_sparsity=40)`` (notebook 6) and
``northsea.run(n_grid=8, max_obs=800)`` (notebook 7), the widths of
tests/test_experiments.py, at 5 iterations.

The JAX reference runs once per module (a module fixture, x64 on, its data
cast to float32 as in production); the port runs on the CPU in float32.
Each model is held at float32's tolerance (RTOL = 1e-3, as in
tests/test_torch_experiments.py): the final loss and metric-row entries per
entry, the q(v) means and variances within RTOL of their largest magnitude.
The largest gap held (printed at the module's end with -s): 9.8e-6 on the
CPU.

``simtracks``'s ``svgp`` member trains at lr 0.05 from the zoo's z grid of
spacing 0.1, as ``univariate``'s does (ROADMAP queue 3, item 19): its first
Adam step lands inducing points on each other, and its float32 trajectory
is then set by roundoff. It is held after its first step (the port's
``run(n_iters=1)`` against the JAX package's calls for that member; gaps
7.9e-8 in the loss, 5.4e-7 in q(v) measured), as phase 20 of
``chip_smoke.py`` holds it; at 5 steps its values must be finite.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vggp_tpu import train as jtrain
from vggp_tpu.data.simulation import generate_track, synthetic_ssh_field
from vggp_tpu.experiments import misc as jmisc
from vggp_tpu.experiments import northsea as jnorthsea
from vggp_tpu.experiments import simtracks as jsimtracks
from vggp_tpu.experiments import zoo as jzoo
from vggp_tpu.features import CellIntegralFeature
from vggp_tpu.models import sgpr as jsgpr
from vggp_tpu.utils import min_max_scaling, simpson_grid_2d

from vggp_tpu_torch.experiments import northsea, simtracks

from test_torch_experiments import (  # noqa: F401 (the fixtures are used by name)
    one_torch_thread, report_largest_gap, ITERS, _close_max, _hold_member)

SIM = dict(n_grid=8, observation_sparsity=40, n_iters=ITERS)
NORTH = dict(n_grid=8, max_obs=800, n_iters=ITERS)


def _simtracks_svgp_one_step():
    """simtracks's ``svgp`` member after one Adam step by the JAX package's
    calls of ``vggp_tpu/experiments/simtracks.py:38-86`` (data in float32):
    (final loss, metric row, q(v) mean)."""
    field, lons, lats = synthetic_ssh_field(seed=3)
    lon, lat, ssh = generate_track(field, lons, lats, 2, 2.0, SIM["observation_sparsity"])
    x1, *_ = min_max_scaling(jnp.asarray(lon, jnp.float32), min=float(lons[0]),
                             max=float(lons[-1]))
    x2, *_ = min_max_scaling(jnp.asarray(lat, jnp.float32), min=float(lats[0]),
                             max=float(lats[-1]))
    X, y = jnp.stack([x1, x2], axis=1), jnp.asarray(ssh, jnp.float32)
    n_grid = SIM["n_grid"]
    truth = simpson_grid_2d(field.T, np.linspace(0, 1, field.shape[1]),
                            np.linspace(0, 1, field.shape[0]), n_grid)
    grids = (CellIntegralFeature.from_lims(n_grid, 0.0, 1.0),) * 2
    spec = jzoo.sgpr_specs_2d(n_inducing=10, n_frequencies=8, n_knots=n_grid,
                              n_cells=n_grid)["svgp"]
    p0 = jtrain.non_informative_init(spec.init_params(), X, y)
    p, hist = jtrain.fit(lambda q: jsgpr.loss(spec, q, X, y), p0, 1, 0.05)
    qv = jax.jit(lambda q: jsgpr.q_v(spec, q, X, y, grids, full_cov=False))(p)
    return {"final_loss": float(np.asarray(hist["loss"])[-1]),
            "metrics": jmisc.evaluation_metric_row(truth, qv, y),
            "qv_mean": np.asarray(qv.mean).reshape(n_grid, n_grid)}


@pytest.fixture(scope="module")
def simtracks_runs():
    one_step = simtracks.run(device="cpu", **{**SIM, "n_iters": 1})["models"]["svgp"]
    return (simtracks.run(device="cpu", **SIM), jsimtracks.run(**SIM),
            (one_step, _simtracks_svgp_one_step()))


@pytest.mark.parametrize("model", ["exactgp", "svgp", "vffgp", "asvgp", "griddedgp"])
def test_simtracks_matches_jax(simtracks_runs, model):
    got_all, want_all, _ = simtracks_runs
    assert got_all["n_obs"] == want_all["n_obs"] > 50
    assert list(got_all["models"]) == list(want_all["models"])
    np.testing.assert_array_equal(got_all["truth"], want_all["truth"], strict=True)
    got, want = got_all["models"][model], want_all["models"][model]
    assert sorted(got) == sorted(want)
    assert got["qv_mean"].shape == (8, 8) and np.isfinite(got["steps_per_sec"])
    if model == "svgp":
        assert all(np.all(np.isfinite(got[k])) for k in ("final_loss", "metrics", "qv_mean"))
        return
    _hold_member(got, want, keys_max=("qv_mean",))


def test_simtracks_svgp_matches_jax_after_one_step(simtracks_runs):
    """The roundoff-set member where its trajectory is still determined."""
    got, want = simtracks_runs[2]
    _hold_member(got, want, keys_max=("qv_mean",))


@pytest.fixture(scope="module")
def northsea_runs():
    return northsea.run(device="cpu", **NORTH), jnorthsea.run(**NORTH)


@pytest.mark.parametrize("model", ["asvgp", "griddedgp"])
def test_northsea_matches_jax(northsea_runs, model):
    got_all, want_all = northsea_runs
    assert got_all["n_obs"] == want_all["n_obs"] == NORTH["max_obs"]
    assert list(got_all["models"]) == list(want_all["models"])
    got, want = got_all["models"][model], want_all["models"][model]
    assert sorted(got) == sorted(want)
    assert got["qv_mean"].shape == (8, 8) and got["qv_var"].min() > 0
    _hold_member(got, want, keys_max=("qv_mean", "qv_var"), keys_each=())


def test_northsea_synthetic_observations_equal_jax():
    """The synthetic North Sea month (no archive): the same arrays."""
    for g, w in zip(northsea._load_obs(None), jnorthsea._load_obs(None), strict=True):
        np.testing.assert_array_equal(g, w, strict=True)
