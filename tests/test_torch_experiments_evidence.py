"""The port's ``evidence`` experiment against the JAX package: for each of
``KINDS`` an exact-GP fit, its Laplace approximation, the Laplace log
evidence and the plug-in and hyper-marginalized predictive calibration.

*Exact holds:* the host float64 Grams and the drawn data equal the JAX
package's arrays.

*The experiment:* ``evidence.run(n_train=60, n_test=80, n_marg_samples=64)``
at 5 iterations in both packages, the JAX run in float32 as in production
(``jax.enable_x64(False)``: its ``jnp.asarray`` of float64 numpy gives
float32 there, float64 under the suite's x64), the port on the CPU in
float32, its Hessians too. The Laplace draws of the marginalized predictions
are one table (``_torch_draw_table.DrawTable``): the (64, 3) standard
normals at the JAX run's ``PRNGKey(seed + 3)``, which every kind reuses.

Held at float32's RTOL = 1e-3 per entry: each kind's final loss, log
evidence, and the plug-in and marginalized NLPD and CRPS; the ranking
equal. The 90% coverages are fractions of the 80 test points inside an
interval, so one point that roundoff moves across an interval's edge
changes them by 1/80: they are held within one such flip.
"""

import sys

import jax
import numpy as np
import pytest

from vggp_tpu.experiments import evidence as jevidence

from vggp_tpu_torch.experiments import evidence

from _torch_draw_table import DrawTable
from test_torch_experiments import (RTOL, _close_each, one_torch_thread,  # noqa: F401
                                    report_largest_gap)

ITERS = 5
SMALL = dict(n_train=60, n_test=80, n_marg_samples=64, n_iters=ITERS)


@pytest.mark.parametrize("kind", list(jevidence.KINDS) + ["unknown"])
def test_host_gram_equals_jax(kind):
    x = np.sort(np.random.default_rng(2).random(30))
    if kind == "unknown":
        for mod in (evidence, jevidence):
            with pytest.raises(ValueError):
                mod._host_gram(kind, x, 1.0, 0.2)
        return
    np.testing.assert_array_equal(evidence._host_gram(kind, x, 1.3, 0.2),
                                  jevidence._host_gram(kind, x, 1.3, 0.2), strict=True)


@pytest.mark.parametrize("kind", ["matern12", "rbf"])
def test_drawn_data_equal_jax(kind):
    for g, w in zip(evidence._draw_gp_data(kind, 50, 0.1, 3),
                    jevidence._draw_gp_data(kind, 50, 0.1, 3), strict=True):
        np.testing.assert_array_equal(g, w, strict=True)


@pytest.fixture(scope="module")
def evidence_runs():
    with jax.enable_x64(False):
        table = DrawTable().laplace(3, 64, 3, calls=len(jevidence.KINDS))
    with pytest.MonkeyPatch.context() as mp:
        table.patch(mp)
        with jax.enable_x64(False):
            want = jevidence.run(**SMALL)
        got = evidence.run(device="cpu", **SMALL)
    return got, want


def test_evidence_matches_jax(evidence_runs):
    got, want = evidence_runs
    assert list(got) == list(want)
    assert (got["gen_kind"], got["n_train"]) == ("matern32", 60)
    assert list(got["models"]) == list(jevidence.KINDS)
    assert got["evidence_ranking"] == want["evidence_ranking"]


@pytest.mark.parametrize("kind", jevidence.KINDS)
def test_evidence_kind_matches_jax(evidence_runs, kind):
    got, want = (r["models"][kind] for r in evidence_runs)
    assert list(got) == list(want) + ["steps_per_sec"] and got["steps_per_sec"] > 0
    _close_each(got["final_loss"], want["final_loss"])
    _close_each(got["log_evidence"], want["log_evidence"])
    for head in ("plugin", "marginalized"):
        assert list(got[head]) == ["nlpd", "crps", "coverage90"]
        _close_each([got[head]["nlpd"], got[head]["crps"]],
                    [want[head]["nlpd"], want[head]["crps"]])
        assert abs(got[head]["coverage90"] - want[head]["coverage90"]) <= 1 / 80 + 1e-12


class _Ran(Exception):
    pass


def test_evidence_cli(monkeypatch):
    def fake_run(**kwargs):
        raise _Ran(kwargs)

    monkeypatch.setattr(evidence, "run", fake_run)
    monkeypatch.setattr(sys, "argv", ["evidence", "--gen-kind", "rbf", "--device", "cpu"])
    with pytest.raises(_Ran) as ran:
        evidence.main()
    assert ran.value.args[0] == {"gen_kind": "rbf", "n_train": 200,
                                 "outdir": "results/torch/evidence", "device": "cpu"}
