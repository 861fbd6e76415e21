"""The harness on the CPU at small sizes: found by name, refusing to run
without a card, and catching each fault a cell can have. These drive the
rest of a run (set-up, window, check, result) past the look for a chip."""

import io
import json
import shutil
import subprocess
import sys
import time

import pytest
import torch

from gpbench import harness

from conftest import ROOT, bench, cells


def _run(cell, seconds=0.5, trace=False):
    out, err = io.StringIO(), io.StringIO()
    rc = harness.run_cell(cell, cell.seed, seconds, trace, cell.device, time.perf_counter(),
                          out=out, err=err)
    assert rc == 0, err.getvalue()
    return json.loads(out.getvalue().strip().splitlines()[-1]), err.getvalue()


CELLS, FIT_CELLS, SERVE_CELLS = cells(), cells("fit"), cells("serve")


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(small_cell, workload):
    # a window long enough for two units on a loaded CPU: a tail needs two
    result, err = _run(small_cell(workload), seconds=3.0)
    assert result["correct"] is True
    assert list(result)[-1] == "checks"
    assert result["attempted"] >= 1 and result["failed"] == 0
    e2e = harness.find_cell(bench(), workload).end_to_end
    names = {m["name"] for m in e2e}
    # no device on the CPU: a metric of the device's trace finds nothing to read
    assert {m["name"] for m in e2e if m["source"] == "host_clock"} <= set(result["metrics"])
    assert set(result["metrics"]) <= names
    last = err.strip().splitlines()[-len(result["checks"]):]
    assert all(line.startswith("check ") and " limit " in line for line in last)


@pytest.mark.parametrize("workload", CELLS)
def test_traced_run_reports_per_layer_metrics(small_cell, workload):
    result, _ = _run(small_cell(workload), trace=True)
    assert result["correct"] is True
    assert {m["name"] for m in harness.find_cell(bench(), workload).per_layer
            if not m["name"].endswith("_roofline")} <= set(result["metrics"])
    assert "busy_s" in result["device"] and result["device"]["window_s"] > 0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    # no device on the CPU: the launches read 0, no kernel's roofline is reported
    assert not any(k.endswith("_roofline") for k in result["metrics"])


def _wrap_step(monkeypatch, wrap):
    """``train.make_step_fn`` builds its step over ``wrap(loss_fn)``."""
    from vggp_tpu_torch import train

    orig = train.make_step_fn
    monkeypatch.setattr(train, "make_step_fn",
                        lambda loss_fn, raw, opt: orig(wrap(loss_fn), raw, opt))


def _fault_half_batch(monkeypatch):
    def wrap(loss_fn):
        def half(q, xb, yb):
            n = yb.shape[0] // 2
            return loss_fn(q, xb[:n], yb[:n])
        return half

    _wrap_step(monkeypatch, wrap)


def _fault_state_unchanged(monkeypatch):
    from vggp_tpu_torch import train

    monkeypatch.setattr(train, "guarded_update", lambda opt, leaves, val: False)


def _fault_after_first(monkeypatch, later):
    """The first update as the program takes it; ``later(opt, leaves, val)``
    in place of every one after it."""
    from vggp_tpu_torch import train

    orig, calls = train.guarded_update, []

    def update(opt, leaves, val):
        calls.append(1)
        return orig(opt, leaves, val) if len(calls) == 1 else later(opt, leaves, val)

    monkeypatch.setattr(train, "guarded_update", update)


def _fault_updates_skipped(monkeypatch):
    _fault_after_first(monkeypatch, lambda opt, leaves, val: False)


def _fault_updates_halved(monkeypatch):
    from vggp_tpu_torch import train

    orig = train.guarded_update

    def halved(opt, leaves, val):
        for group in opt.param_groups:
            group["lr"] *= 0.5
        try:
            return orig(opt, leaves, val)
        finally:
            for group in opt.param_groups:
                group["lr"] *= 2.0

    _fault_after_first(monkeypatch, halved)


def _fault_loss_altered(monkeypatch):
    from vggp_tpu_torch import train

    orig = train.make_step_fn

    def make(loss_fn, raw, opt):
        step = orig(loss_fn, raw, opt)
        return lambda *a: step(*a) * (1.0 + 1e-3)

    monkeypatch.setattr(train, "make_step_fn", make)


FIT_FAULTS = {"state_unchanged": _fault_state_unchanged,
              "half_batch": _fault_half_batch,
              "updates_after_first_skipped": _fault_updates_skipped,
              "updates_after_first_halved": _fault_updates_halved,
              "loss_altered": _fault_loss_altered}


@pytest.mark.parametrize("fault", sorted(FIT_FAULTS))
@pytest.mark.parametrize("workload", FIT_CELLS)
def test_fit_fault_is_caught(small_cell, monkeypatch, workload, fault):
    cell = small_cell(workload)
    FIT_FAULTS[fault](monkeypatch)
    result, _ = _run(cell)
    assert result["correct"] is False


def _serve_fault(monkeypatch, fault):
    from vggp_tpu_torch.models import sgpr, svgp

    # every family's head, so that any serving cell meets the fault
    for mod in (svgp, sgpr):
        orig = mod.posterior_from_state
        last = {}

        def faulty(spec, params, state, xs, *a, _orig=orig, _last=last, **k):
            g = _orig(spec, params, state, xs, *a, **k)
            if fault == "answer_altered":
                g.mean[0] += 0.1 * g.mean.abs().max()
            elif fault == "half_left_out":
                g.var[g.var.shape[0] // 2:] = 0.0
            elif fault == "stale_answer":
                prev = _last.get("g")
                _last["g"] = g
                if prev is not None:
                    return prev
            return g

        monkeypatch.setattr(mod, "posterior_from_state", faulty)


@pytest.mark.parametrize("fault", ["answer_altered", "half_left_out", "stale_answer"])
@pytest.mark.parametrize("workload", SERVE_CELLS)
def test_serve_fault_is_caught(small_cell, monkeypatch, workload, fault):
    cell = small_cell(workload)
    _serve_fault(monkeypatch, fault)
    result, _ = _run(cell)
    assert result["correct"] is False


def test_new_files_are_found_by_name(tmp_path, small_cell):
    """A configuration, a traffic mix, a metric reader and a limits file added
    to copies of their folders are found by name, run.py unedited."""
    shutil.copytree(ROOT / "gpbench", tmp_path / "gpbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    base = tmp_path / "gpbench"
    cfg = harness.load_json(base / "configs" / "svgp512_m12.json")
    cfg.update(name="svgp24_m12", cells=[24, 20], num_data=6000)
    (base / "configs" / "svgp24_m12.json").write_text(json.dumps(cfg))
    (base / "traffic" / "fit.b1500.json").write_text(json.dumps(
        {"driver": "fit", "batch": 1500, "warm_units": 1, "check_block": 700}))
    (base / "limits" / "svgp24.fit.b1500.json").write_text(
        json.dumps({"loss": 1e-5, "grad": 1e-3, "change": 1e-3}))
    (base / "metrics" / "steps_in_window.py").write_text(
        "def read(rec):\n    return float(rec['units'])\n")
    bench_ = bench()
    bench_["configs"].append({"name": "svgp24_m12", "source": "a test", "reduced": ["cells"],
                             "file": "gpbench/configs/svgp24_m12.json", "why": "a test"})
    bench_["workloads"].append({"name": "svgp24.fit.b1500", "config": "svgp24_m12",
                               "traffic": "fit.b1500", "chips": 1, "why": "a test"})
    bench_["end_to_end"].append({"name": "steps_in_window", "unit": "steps", "better": "higher",
                                "bound": 0.05, "source": "host_clock",
                                "workloads": ["svgp24.fit.b1500"]})
    for m in bench_["end_to_end"] + bench_["per_layer"]:
        if FIT_CELLS[0] in m.get("workloads", []):
            m["workloads"].append("svgp24.fit.b1500")
    assert (base / "run.py").read_bytes() == (ROOT / "gpbench" / "run.py").read_bytes()
    cell = harness.find_cell(bench_, "svgp24.fit.b1500", tmp_path)
    assert cell.cfg["cells"] == [24, 20] and cell.traffic["batch"] == 1500
    cell.seed, cell.device = 7, torch.device("cpu")
    result, _ = _run(cell)
    assert result["correct"] is True
    assert result["metrics"]["steps_in_window"]["value"] == result["attempted"]
    assert "setup_s" in result["metrics"]


def test_no_card_no_result():
    """Without a CUDA device run.py exits non-zero and prints no metric."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "gpbench/run.py", "--workload", CELLS[0],
                          "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "metrics" not in out.stdout and "correct" not in out.stdout


def test_without_the_program_no_result(tmp_path):
    """A directory with BENCHMARK.json and gpbench/ alone gives no result."""
    shutil.copytree(ROOT / "gpbench", tmp_path / "gpbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    code = ("import sys, time; sys.path.insert(0, '.'); import torch; "
            "from gpbench import harness; "
            "cell = harness.find_cell(harness.load_json(harness.ROOT / 'BENCHMARK.json'), "
            f"{CELLS[0]!r}); "
            "sys.exit(harness.run_cell(cell, 1, 1.0, False, torch.device('cpu'), "
            "time.perf_counter()))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert "metrics" not in out.stdout
