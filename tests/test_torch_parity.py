"""The port's parity experiment (``vggp_tpu_torch.experiments.parity``)
against the JAX package's, at ``sparsity=20`` and 2 iterations.

The JAX package's whole ``parity.run`` takes over 60 s on the CPU (its column
compiles ten fits), so the port's column is held model by model against
the JAX functions that the JAX column calls (``vggp_tpu/experiments/
parity.py:104-142``: the zoo's specs, the free-point SVGP from seed 0,
``non_informative_init``, ``train.fit``, ``q_v``) on the train window, at
float32's tolerance (RTOL = 1e-3, as in tests/test_torch_experiments.py):
the final loss and each metric entry. The largest gap held (printed at the
module's end with -s): 2.3e-5 on the CPU. The reference column (the port's copy of the torch
float64 oracle, on the CPU) must equal the JAX package's oracle bit for
bit on both windows: metrics, final loss and hyperparameters.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vggp_tpu import train as jtrain
from vggp_tpu.experiments import parity as jparity
from vggp_tpu.experiments import torch_oracle as joracle
from vggp_tpu.experiments import zoo as jzoo
from vggp_tpu.experiments.configs import EXP_1_TEST, EXP_1_TRAIN
from vggp_tpu.experiments.loaders import load_gulf_stream_data
from vggp_tpu.features import CellIntegralFeature
from vggp_tpu.models import exact as jexact
from vggp_tpu.models import freesvgp as jfreesvgp
from vggp_tpu.models import sgpr as jsgpr

from vggp_tpu_torch.experiments import parity

from test_torch_experiments import (  # noqa: F401 (the fixtures are used by name)
    one_torch_thread, report_largest_gap, _close_each)

KW = dict(n_iters=2, lr=0.01, sparsity=20, svgp_m=100, n_omegas=5, exact_subsample=4)


def _window(exp_dict):
    ds = load_gulf_stream_data("data/dc_obs", "data/dc_ref", exp_dict)
    X, y = ds.obs_train_data(KW["sparsity"])
    n_splines = exp_dict["N_SPLINES"]
    return (np.asarray(X, np.float64), np.asarray(y, np.float64).reshape(-1),
            ds.grid_ref_data_simpson(n_splines), n_splines)


def _model_data(name, X, y):
    k = KW["exact_subsample"]
    return (X[::k], y[::k]) if name == "exactgp" else (X, y)


def _oracle_rows(exp_dict):
    """The JAX package's oracle column of one window."""
    X, y, truth, n_splines = _window(exp_dict)
    rows = {}
    for name in parity.ZOO:
        Xm, ym = _model_data(name, X, y)
        (mean, var), losses, hyps = joracle.fit(
            name, Xm, ym, np.linspace(0.0, 1.0, n_splines + 1), n_splines,
            n_iters=KW["n_iters"], lr=KW["lr"], m_svgp=KW["svgp_m"], n_omegas=KW["n_omegas"])
        rows[name] = {"metrics": dict(zip(jparity.METRIC_NAMES,
                                          jparity._metric_row(truth, mean, var, ym))),
                      "final_loss": losses[-1], "hyps": hyps}
    return rows


def _jax_column(name):
    """JAX's column for one model on the train window, by the calls of
    ``vggp_tpu/experiments/parity.py:104-142`` (one fit: the timed second
    fit equals the first)."""
    X, y, truth, n_splines = _window(EXP_1_TRAIN)
    Xm, ym = _model_data(name, X, y)
    Xj, yj = jnp.asarray(Xm, jnp.float32), jnp.asarray(ym, jnp.float32)
    grids = (CellIntegralFeature.from_lims(n_splines, 0.0, 1.0),) * 2
    if name == "svgp":
        spec, mod = jfreesvgp.FreeSVGPSpec(kinds=("matern12", "matern12"),
                                           m=KW["svgp_m"]), jfreesvgp
        p0 = spec.init_params(jnp.float32, seed=0)
    else:
        specs = {"exactgp": jzoo.exact_spec(2)}
        specs.update(jzoo.sgpr_specs_2d(n_inducing=10, n_frequencies=KW["n_omegas"],
                                        n_knots=n_splines, n_cells=n_splines))
        spec, mod = specs[name], (jexact if name == "exactgp" else jsgpr)
        p0 = spec.init_params()
    p0 = jtrain.non_informative_init(p0, Xj, yj)
    p, hist = jtrain.fit(lambda q: mod.loss(spec, q, Xj, yj), p0, KW["n_iters"], KW["lr"])
    qv = jax.jit(lambda q: mod.q_v(spec, q, Xj, yj, grids, full_cov=False))(p)
    return {"metrics": dict(zip(jparity.METRIC_NAMES,
                                jparity._metric_row(truth, qv.mean, qv.var, ym))),
            "final_loss": float(np.asarray(hist["loss"])[-1])}


@pytest.fixture(scope="module")
def parity_runs():
    got = parity.run(device="cpu", **KW)
    oracle = {"train": _oracle_rows(EXP_1_TRAIN), "test": _oracle_rows(EXP_1_TEST)}
    return got, oracle, {name: _jax_column(name) for name in parity.ZOO}


@pytest.mark.parametrize("name", parity.ZOO)
def test_parity_port_column_matches_jax(parity_runs, name):
    got, _, jax_column = parity_runs
    rec = got["splits"]["train"]["models"][name]
    assert list(rec) == ["reference_f64_cpu", "vggp_tpu_torch_f32"]
    port, want = rec["vggp_tpu_torch_f32"], jax_column[name]
    assert list(port["metrics"]) == list(want["metrics"])
    _close_each(port["final_loss"], want["final_loss"])
    _close_each(list(port["metrics"].values()), list(want["metrics"].values()))
    assert np.isfinite(port["steps_per_sec"]) and port["steps_per_sec"] > 0


@pytest.mark.parametrize("split", ["train", "test"])
@pytest.mark.parametrize("name", parity.ZOO)
def test_parity_oracle_column_is_the_jax_oracle_bitwise(parity_runs, split, name):
    got, oracle, _ = parity_runs
    ref = got["splits"][split]["models"][name]["reference_f64_cpu"]
    want = oracle[split][name]
    assert ref["metrics"] == want["metrics"]
    assert ref["final_loss"] == want["final_loss"] and ref["hyps"] == want["hyps"]


def test_parity_table_names_the_port_column(parity_runs):
    got = parity_runs[0]
    assert got["config"] == {**KW, "device": "cpu"}
    assert [got["splits"][s]["n_obs"] for s in ("train", "test")] == [
        len(_window(d)[1]) for d in (EXP_1_TRAIN, EXP_1_TEST)]
    md = parity._markdown(got)
    assert md.startswith("# Parity: reference-style torch f64 (CPU) vs vggp_tpu_torch_f32 (cpu)")
    assert "| griddedgp | vggp_tpu_torch_f32 |" in md and "vggp_tpu_f32" not in md
