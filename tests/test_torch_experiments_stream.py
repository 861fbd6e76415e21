"""The port's collapsed-model experiments — ``streaming``, ``multioutput``
and ``multiscale`` — against the JAX package.

Each runs in both packages at a small size and a few iterations from the
same seeds: the JAX run in float32 as in production
(``jax.enable_x64(False)``; ``multioutput`` and ``multiscale`` hand it
float64 numpy, which production turns into float32), the port on the CPU in
float32. None of the three draws random numbers after its data.

Held at float32's RTOL = 1e-3 per entry: ``streaming``'s per-pass q(v)
RMSE, NLPD and mean σ, the drift segment (forgetting, anchored, reanchored
after the hyperparameter refresh) and its streamed-vs-batch gaps (each a
float32 roundoff level: both below 1e-3 of the product, the exactness
contract, not held to each other); ``multioutput``'s final loss, both
fits' sparse-output metrics, q(v) errors, learned B, correlation and means;
``multiscale``'s final loss, every RMSE and the component variances, with
both lengthscales frozen exactly at their initial values.
"""

import sys

import numpy as np
import pytest
import torch

from vggp_tpu.experiments import multioutput as jmultioutput
from vggp_tpu.experiments import multiscale as jmultiscale
from vggp_tpu.experiments import streaming as jstreaming

from vggp_tpu_torch.experiments import multioutput, multiscale, streaming

import _torch_jax_runs
from test_torch_experiments import (RTOL, _close_each, one_torch_thread,  # noqa: F401
                                    report_largest_gap)

ITERS = 5
STREAMING = dict(m_side=6, n_cells=8, n_passes=3, n_tracks=3, n_per_track=24,
                 n_hyper_iters=ITERS)
MULTIOUTPUT = dict(n_iters=ITERS, n_dense_tracks=6, n_sparse_obs=30, m_axis=8, grid_n=6)
MULTISCALE = dict(n_iters=ITERS)


@pytest.fixture(scope="module")
def jax_runs():
    """The three JAX runs, started together at the module's first use, each
    in a process of its own (``_torch_jax_runs``; most of their time is XLA
    compiling op by op), while the port's runs go on in the test's process."""
    pool, results = _torch_jax_runs.start(
        {"streaming": STREAMING, "multioutput": MULTIOUTPUT, "multiscale": MULTISCALE})
    yield results
    pool.terminate()


def _both(jax_runs, name, trun, kw):
    got = trun(device="cpu", **kw)
    return got, jax_runs[name].get(timeout=300)


# --------------------------------------------------------------------------- #
# streaming
# --------------------------------------------------------------------------- #

def test_streaming_passes_and_truth_equal_jax():
    for p in (0, 3):
        for phase in (0.0, 0.6):
            for g, w in zip(streaming.mission_pass(p, 24, 3, 0.05, 0, phase),
                            jstreaming.mission_pass(p, 24, 3, 0.05, 0, phase), strict=True):
                np.testing.assert_array_equal(g, w, strict=True)
    for phase in (0.0, 0.6):
        np.testing.assert_array_equal(streaming.truth_cell_means(8, phase),
                                      jstreaming.truth_cell_means(8, phase), strict=True)


@pytest.fixture(scope="module")
def streaming_runs(jax_runs):
    return _both(jax_runs, "streaming", streaming.run, STREAMING)


def test_streaming_matches_jax(streaming_runs):
    got, want = streaming_runs
    assert list(got) == list(want)
    assert (got["m_total"], got["n_per_pass"]) == (36, 72)
    assert len(got["per_pass"]) == len(want["per_pass"]) == 3
    for g, w in zip(got["per_pass"], want["per_pass"], strict=True):
        assert (g["pass"], g["n_seen"]) == (w["pass"], w["n_seen"])
        for k in ("qv_rmse", "qv_nlpd", "mean_std"):
            _close_each(g[k], w[k])
    for k, w in want["drift"].items():
        _close_each(got["drift"][k], w)
    assert got["assimilation_passes_per_sec"] > 0 and got["hyper_fit_seconds"] > 0


def test_streaming_stream_equals_batch(streaming_runs):
    """The exactness contract in both packages: the streamed q(v) equals
    the batch SGPR's to float32 roundoff (gaps in cell-mean units)."""
    got, want = streaming_runs
    for r in (got, want):
        assert r["stream_vs_batch_qv_mean_gap"] < 1e-3
        assert r["stream_vs_batch_qv_var_gap"] < 1e-3


# --------------------------------------------------------------------------- #
# multioutput
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def multioutput_runs(jax_runs):
    return _both(jax_runs, "multioutput", multioutput.run, MULTIOUTPUT)


def test_multioutput_matches_jax(multioutput_runs):
    got, want = multioutput_runs
    assert list(got) == list(want) + ["steps_per_sec"]
    assert (got["n_dense"], got["n_sparse"]) == (want["n_dense"], want["n_sparse"]) == (384, 30)
    _close_each(got["final_loss"], want["final_loss"])
    for model in ("joint_icm", "independent"):
        g, w = got["sparse_output_test"][model], want["sparse_output_test"][model]
        assert list(g) == list(w)
        _close_each(list(g.values()), list(w.values()))
    # the q(v) errors move by at most max|Δmean|: within RTOL of the scale
    for k in ("qv_err_output0", "qv_err_output1"):
        assert abs(got[k] - want[k]) <= RTOL * want["qv_scale"], k
    assert got["qv_scale"] == want["qv_scale"]
    _close_each(got["learned_B"], want["learned_B"])
    _close_each(got["learned_corr"], want["learned_corr"])
    _close_each(got["learned_means"], want["learned_means"])


# --------------------------------------------------------------------------- #
# multiscale
# --------------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def multiscale_runs(jax_runs):
    return _both(jax_runs, "multiscale", multiscale.run, MULTISCALE)


def test_multiscale_matches_jax(multiscale_runs):
    """The final loss and component variances per entry; each RMSE (of a
    posterior mean against its truth) moves by at most max|Δmean|, so it is
    held within RTOL of its truth's largest magnitude."""
    got, want = multiscale_runs
    assert list(got) == list(want) + ["steps_per_sec"]
    assert got["n"] == 400
    for k in ("slow_scale", "fast_scale"):
        assert got[k] == want[k], k
    for k in ("final_loss", "component_vars"):
        _close_each(got[k], want[k])
    xs = np.linspace(0.02, 0.98, 200)
    slow, fast = jmultiscale._slow(xs), jmultiscale._fast(xs)
    for k, truth in (("total_rmse_sum_model", slow + fast),
                     ("total_rmse_single_kernel", slow + fast),
                     ("slow_component_rmse", slow), ("fast_component_rmse", fast)):
        assert abs(got[k] - want[k]) <= RTOL * np.abs(truth).max(), k


def test_multiscale_freezes_both_lengthscales(monkeypatch):
    """``train.fit(trainable=...)`` keeps both components' lengthscales at
    0.5 and 0.04 exactly while the variances move."""
    from vggp_tpu_torch import train

    seen = {}
    real_fit = train.fit

    def spy(loss_fn, params, n_iters, learning_rate=0.1, trainable=None):
        out = real_fit(loss_fn, params, n_iters, learning_rate, trainable=trainable)
        if trainable is not None:
            with torch.no_grad():
                seen["init"] = train.constrain(train.raw_leaves_from(params))
            seen["params"] = out[0]
        return out

    monkeypatch.setattr(train, "fit", spy)
    multiscale.run(n_iters=ITERS, device="cpu")
    comps = seen["params"]["components"]
    # the frozen raw leaf maps back through the floored softplus: the
    # float32 round trip of its initial value, exactly
    assert [float(c["axes"][0]["lengthscale"]) for c in comps] == pytest.approx([0.5, 0.04])
    for c, c0 in zip(comps, seen["init"]["components"], strict=True):
        assert torch.equal(c["axes"][0]["lengthscale"], c0["axes"][0]["lengthscale"])
    assert float(comps[1]["axes"][0]["variance"]) != np.float32(0.1)


class _Ran(Exception):
    pass


@pytest.mark.parametrize("module", [streaming, multioutput, multiscale])
def test_cli_passes_its_options(module, monkeypatch):
    def fake_run(**kwargs):
        raise _Ran(kwargs)

    monkeypatch.setattr(module, "run", fake_run)
    name = module.__name__.rsplit(".", 1)[1]
    monkeypatch.setattr(sys, "argv", [name, "--device", "cpu"])
    with pytest.raises(_Ran) as ran:
        module.main()
    assert ran.value.args[0]["outdir"] == f"results/torch/{name}"
    assert ran.value.args[0]["device"] == "cpu"
