"""Tests of the benchmark harness. They run on the CPU at small sizes; those
marked ``cuda`` need the card and skip without one (decided inside each
test). Run from the repository root: ``python -m pytest gpbench/tests -q``."""

import copy
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cells(driver: str = None) -> list:
    """The names of BENCHMARK.json's cells, those of one driver if given."""
    out = []
    for w in bench()["workloads"]:
        traffic = json.loads((ROOT / "gpbench" / "traffic" / f"{w['traffic']}.json").read_text())
        if driver is None or traffic["driver"] == driver:
            out.append(w["name"])
    return out


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device (skips without one)")


@pytest.fixture
def small_cell():
    """small_cell(workload, seed): the cell at a CPU test's size, the
    ``test_size`` that its configuration and its traffic files state."""
    import torch

    from gpbench import harness

    def make(workload: str, seed: int = 2**31 + 11):
        cell = harness.find_cell(bench(), workload)
        cell.cfg = copy.deepcopy(cell.cfg)
        cell.cfg.update(cell.cfg["test_size"])
        cell.traffic = dict(cell.traffic, **cell.traffic["test_size"])
        cell.seed, cell.device = seed, torch.device("cpu")
        return cell

    return make


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
