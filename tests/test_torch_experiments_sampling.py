"""The port's sampling experiments — ``poisson``, ``exceedance`` and
``velocity`` — against the JAX package.

Each runs in both packages at a small size and a few iterations: the JAX
run in float32 as in production (``jax.enable_x64(False)``; the three in
processes of their own, ``_torch_jax_runs``, started together at the
module's first use), the port on the CPU in float32, from the same seeds. The randomness is one table for
both (``_torch_draw_table.DrawTable``): the minibatch indices are the JAX
run's own (``port_minibatches``), and every pathwise draw — frequencies,
phases and z of each sample, keyed as each JAX sampler splits its
``PRNGKey(seed + k)`` — the Poisson counts (inverse CDF of one table of
uniforms) and nothing else. The independent-marginal baselines draw from
the same numpy seeds in both packages.

Held at float32's RTOL = 1e-3: every final loss, metric and scalar per
entry, every sampled functional's {mean, std, q05, q95} per entry. The
exceedance AREAS are the one exception: a fraction of points above τ, so a
sample value that float32 roundoff moves across τ changes it by one point.
They are held within two such flips, 2/n of the lattice's n points (2/256
and 2/64 here), the bound stated per key in ``AREA_KEYS``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vggp_tpu.experiments import exceedance as jexceedance
from vggp_tpu.experiments import poisson as jpoisson

from vggp_tpu_torch.experiments import exceedance, poisson, velocity

import _torch_jax_runs
from _torch_draw_table import DrawTable
from test_torch_experiments import (RTOL, _close_each, one_torch_thread,  # noqa: F401
                                    report_largest_gap)
from test_torch_experiments_spacetime import jax_minibatch_indices, port_minibatches

ITERS = 5
S, F = 32, 64
POISSON = dict(m_side=8, n_grid=4, n_obs=600, n_iters=ITERS, batch_size=256,
               n_quad=12, n_count_samples=S, n_count_features=F)
# enough steps that the posterior reaches τ, so the areas are not all 0
EXCEEDANCE_ITERS = 80
EXCEEDANCE = dict(m_side=8, n_eval=16, n_obs=600, n_iters=EXCEEDANCE_ITERS, batch_size=256,
                  n_samples=S, n_features=F)
VELOCITY = dict(n_iters=ITERS, n_features=12, n_grid=8)


def _tables():
    """Each experiment's draw table (built in the test's process and, from
    its recipe, in its JAX run's)."""
    return {
        "poisson": DrawTable().sampler(11, S, 2, F, (8, 8)).poisson(13, S),
        "exceedance": DrawTable().sampler(1, S, 2, F, (8, 8)).sampler(3, S, 2, F, (8, 8)),
        # the experiment's gradient draws: 96 samples of 1024 features at
        # PRNGKey(seed + 7), z over the 12² inducing cells
        "velocity": DrawTable().sampler(7, 96, 2, 1024, (144,)),
    }


@pytest.fixture(scope="module")
def jax_runs():
    """The three JAX runs under their tables, in processes of their own."""
    jobs = {name: (kw, _tables()[name].recipe) for name, kw in (
        ("poisson", POISSON), ("exceedance", EXCEEDANCE), ("velocity", VELOCITY))}
    pool, results = _torch_jax_runs.start(jobs)
    yield results
    pool.terminate()


def _both(jax_runs, name, trun, kw, batches=None):
    """(the port's result, the JAX package's) of one experiment at ``kw``,
    the port under its table's draws (and ``batches``)."""
    with pytest.MonkeyPatch.context() as mp:
        _tables()[name].patch(mp)
        if batches is None:
            got = trun(device="cpu", **kw)
        else:
            with port_minibatches(batches):
                got = trun(device="cpu", **kw)
    return got, jax_runs[name].get(timeout=300)


def _hold_tree(got, want, skip=()):
    """Every number of a nested result dict per entry at RTOL."""
    assert list(got) == list(want) or set(want) <= set(got), (list(got), list(want))
    for k, w in want.items():
        if k in skip:
            continue
        g = got[k]
        if isinstance(w, dict):
            _hold_tree(g, w, skip)
        elif isinstance(w, (int, float, list, np.floating)) and not isinstance(w, bool):
            _close_each(g, w)
        elif isinstance(w, np.ndarray):
            _close_each(g, w)


# --------------------------------------------------------------------------- #
# poisson
# --------------------------------------------------------------------------- #

def test_poisson_truth_and_counts_equal_jax():
    mx, my = np.linspace(0.0, 1.0, 5), np.sort(np.r_[0.0, np.random.default_rng(2).random(4), 1.0])
    np.testing.assert_array_equal(poisson.truth_integrals(mx, my),
                                  jpoisson.truth_integrals(mx, my), strict=True)
    x, y = np.random.default_rng(3).random((2, 40))
    np.testing.assert_array_equal(poisson.log_intensity(x, y), jpoisson.log_intensity(x, y),
                                  strict=True)
    for kw in ({}, {"n": 300, "seed": 5}):
        for g, w in zip(poisson.generate_counts(**kw), jpoisson.generate_counts(**kw),
                        strict=True):
            np.testing.assert_array_equal(g, w, strict=True)


@pytest.fixture(scope="module")
def poisson_runs(jax_runs):
    with jax.enable_x64(False):
        batches = jax_minibatch_indices(0, 600, 256, ITERS)
    return _both(jax_runs, "poisson", poisson.run, POISSON, batches)


def test_poisson_matches_jax(poisson_runs):
    got, want = poisson_runs
    assert list(got) == list(want)
    assert (got["n_obs"], got["m_total"]) == (600, 64)
    _close_each(got["final_loss"], want["final_loss"])
    _close_each(got["metrics"], want["metrics"])
    _close_each(got["intensity_median_rel_err"], want["intensity_median_rel_err"])
    # max|mean − truth| moves by at most max|Δmean|: within RTOL of the
    # truth's largest magnitude
    truth = jpoisson.truth_integrals(np.linspace(0, 1, 5), np.linspace(0, 1, 5))
    assert abs(got["qv_max_err"] - want["qv_max_err"]) <= RTOL * np.abs(truth).max()


def test_poisson_region_counts_match_jax(poisson_runs):
    """Λ's pathwise and independent distributions, and the predictive
    counts (one table of uniforms), per entry at RTOL; Λ's truth exactly."""
    got, want = poisson_runs
    g, w = got["region_counts"], want["region_counts"]
    assert g["lambda_truth"] == w["lambda_truth"]
    assert (g["region"], g["n_samples"], g["n_quad"]) == (w["region"], S, 144)
    _hold_tree(g, w, skip=("lambda_truth",))
    # the coherence signature at this size: pathwise Λ spreads wider
    assert g["lambda_pathwise"]["std"] > 0 and g["counts_predictive"]["mean"] > 0


# --------------------------------------------------------------------------- #
# exceedance
# --------------------------------------------------------------------------- #

def test_exceedance_field_and_obs_equal_jax():
    x, y = np.random.default_rng(4).random((2, 30))
    np.testing.assert_array_equal(exceedance.field(x, y), jexceedance.field(x, y), strict=True)
    for g, w in zip(exceedance.generate_obs(200, 0.05, 3), jexceedance.generate_obs(200, 0.05, 3),
                    strict=True):
        np.testing.assert_array_equal(g, w, strict=True)


# the area keys and their bound: two indicator flips of the lattice behind
# them (n_eval² = 256 points; the product's 32² = 1024 cells)
AREA_KEYS = {("area_pathwise",): 2 / 256, ("area_independent",): 2 / 256,
             ("product", "area_pathwise"): 2 / 1024, ("product", "area_independent"): 2 / 1024}


@pytest.fixture(scope="module")
def exceedance_runs(jax_runs):
    with jax.enable_x64(False):
        batches = jax_minibatch_indices(0, 600, 256, EXCEEDANCE_ITERS)
    return _both(jax_runs, "exceedance", exceedance.run, EXCEEDANCE, batches)


def test_exceedance_matches_jax(exceedance_runs):
    got, want = exceedance_runs
    assert list(got) == list(want)
    for k in ("tau", "area_truth", "max_truth", "n_obs", "m_total", "n_samples", "n_features"):
        assert got[k] == want[k], k
    for k in ("n_cells", "tau", "area_truth", "max_truth"):
        assert got["product"][k] == want["product"][k], k
    skip = {k[-1] for k in AREA_KEYS} | {"tau", "area_truth", "max_truth", "n_cells",
                                         "steps_per_sec"}
    _hold_tree(got, want, skip=skip)


@pytest.mark.parametrize("path", sorted(AREA_KEYS))
def test_exceedance_areas_match_jax_within_two_flips(exceedance_runs, path):
    got, want = exceedance_runs
    for k in path:
        got, want = got[k], want[k]
    assert list(got) == ["mean", "std", "q05", "q95"]
    for stat in got:
        assert abs(got[stat] - want[stat]) <= AREA_KEYS[path], (stat, got[stat], want[stat])


# --------------------------------------------------------------------------- #
# velocity
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def velocity_runs(jax_runs):
    return _both(jax_runs, "velocity", velocity.run, VELOCITY)


def test_velocity_matches_jax(velocity_runs):
    """The collapsed fit's final loss, both axes' q(dv) metrics, the
    geostrophic velocities and the pathwise speed statistics, per entry."""
    got, want = velocity_runs
    assert list(got) == list(want) == ["steps_per_sec", "final_loss", "grad0", "grad1",
                                       "velocity", "speed"]
    _hold_tree(got, want, skip=("steps_per_sec",))
    assert got["speed"]["exceed_threshold_m_s"] == 0.5
