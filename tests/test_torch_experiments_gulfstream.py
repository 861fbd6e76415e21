"""The port's Gulf Stream experiment (notebooks 6 & 61) against the JAX
package's: ``gulfstream.run(sparsity=10)`` at 5 iterations, without the CV
sweep, on the synthetic train and test windows.

The JAX reference runs once per module (a module fixture, x64 on, its data
cast to float32 as in production); the port runs on the CPU in float32.
Each model of each window is held at float32's tolerance (RTOL = 1e-3, as
in tests/test_torch_experiments.py): the final loss, metric-row and
calibration entries and the history per entry, the q(v) mean and variance
within RTOL of their largest magnitude. The largest gap held (printed at
the module's end with -s): 2.6e-5 on the CPU.

Then the CV sweep on the port alone (``run_cv=True, cv_iters=1``): its
settings (the 12 inducing counts of nb61 cell 32, the 6 frequency counts
of cell 39) and that every row is finite. Its members are held against JAX
by tests/test_torch_families_free.py and tests/test_torch_zoo.py.
"""

import numpy as np
import pytest

from vggp_tpu.experiments import gulfstream as jgulfstream

from vggp_tpu_torch.experiments import gulfstream

from test_torch_experiments import (  # noqa: F401 (the fixtures are used by name)
    one_torch_thread, report_largest_gap, ITERS, _close_each, _close_max, _hold_member)

MODELS = ["exactgp", "svgp", "vffgp", "asvgp", "griddedgp"]


@pytest.fixture(scope="module")
def gulfstream_runs():
    kw = dict(sparsity=10, n_iters=ITERS)
    return gulfstream.run(device="cpu", **kw), jgulfstream.run(**kw)


@pytest.mark.parametrize("split", ["train", "test"])
@pytest.mark.parametrize("model", MODELS)
def test_gulfstream_matches_jax(gulfstream_runs, split, model):
    got_all, want_all = gulfstream_runs
    assert list(got_all) == list(want_all) and got_all["cv"] == {}
    assert list(got_all[split]) == list(want_all[split]) == MODELS
    got, want = got_all[split][model], want_all[split][model]
    assert sorted(got) == sorted(want)
    _hold_member(got, want)
    _close_each(list(got["calibration"].values()), list(want["calibration"].values()))
    _close_max(got["qv"].mean, np.asarray(want["qv"].mean))
    _close_max(got["qv"].var, np.asarray(want["qv"].var))
    assert got["history"]["n_iter"] == ITERS
    for k, v in want["history"].items():
        if isinstance(v, list) and v:
            _close_each(got["history"][k], v)
        else:
            assert got["history"][k] == v, k
    for g, w in zip(_leaves(got["params"]), _leaves(want["params"]), strict=True):
        assert isinstance(g, np.ndarray)
        _close_max(g, np.asarray(w))


def _leaves(tree):
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [tree]


def test_gulfstream_cv_sweep_settings_and_rows():
    """nb61's CV sweeps on the port: 12 free-point SVGPs and 6 VFF sizes,
    one iteration each, every metric row finite."""
    res = gulfstream.run(sparsity=20, n_iters=1, run_cv=True, cv_iters=1, device="cpu")
    sweeps = res["cv"]
    assert list(sweeps) == ["svgp_n_inducing", "vff_n_omegas"]
    assert sweeps["svgp_n_inducing"]["setting"] == [10, 30, 50, 100, 150, 200, 250, 300,
                                                    350, 400, 450, 500]
    assert sweeps["vff_n_omegas"]["setting"] == [1, 3, 5, 7, 10, 12]
    for cv in sweeps.values():
        n = len(cv["setting"])
        for key in ("train_metrics", "val_metrics"):
            assert len(cv[key]) == n
            assert all(len(row) == 6 and np.all(np.isfinite(row)) for row in cv[key]), key
        assert all(s > 0 for s in cv["steps_per_sec"])
        assert cv["train_elbo"] == cv["val_elbo"] == [None] * n
