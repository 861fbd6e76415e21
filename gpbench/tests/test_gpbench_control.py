"""The control, the reference one precision step below what the
configuration states (TF32 products), comes out as not correct against each
cell's own limits; so does each fault planted in a training cell's reference
(half the batch left out, every update after the first skipped). At a size
a CPU test holds, and, on the card, at the cell's own size on three seeds.
The cells are BENCHMARK.json's."""

import math

import pytest

from gpbench import calibrate

from conftest import cells

CELLS = cells()


def _fails(numbers: dict, limits: dict) -> bool:
    return any(not math.isfinite(numbers[k]) or numbers[k] > v for k, v in limits.items())


def _readings(cell) -> dict:
    fn = calibrate.fit_control if cell.traffic["driver"] == "fit" else calibrate.serve_control
    return fn(cell)


@pytest.mark.parametrize("seed", [5, 2**31 + 17, 2**32 + 1])
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_at_a_small_size(small_cell, workload, seed):
    cell = small_cell(workload, seed)
    got = _readings(cell)
    for what, numbers in got.items():
        assert _fails(numbers, cell.limits), (what, numbers, cell.limits)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_at_the_cells_size(card, workload):
    from gpbench import harness

    from conftest import bench

    cell = harness.find_cell(bench(), workload)
    cell.device = card
    for seed in (2**31 + 101, 2**31 + 202, 2**31 + 303):
        cell.seed = seed
        for what, numbers in _readings(cell).items():
            assert _fails(numbers, cell.limits), (what, seed, numbers, cell.limits)
