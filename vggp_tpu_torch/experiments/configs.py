"""Experiment dictionaries (reference's missing
``experiments.gulfstream.experiment_dictionaries`` module).

Key set recovered from nb61 call sites (cells 5, 8, 19, 24): YEAR_FRAME /
MONTH_FRAME / DAY_FRAME / HOUR_FRAME / SATELLITE / N_SPLINES. The 2020a SSH
mapping data challenge covers 2012-10-01 → 2013-09-30; experiment 1 uses
consecutive early-window train/val/test slices of the Envisat track set and
a 20×20 ground-truth grid.

The port's copy of ``vggp_tpu/experiments/configs.py``: the same dictionaries.
"""

EXP_1_TRAIN = {
    "SATELLITE": "envisat",
    "YEAR_FRAME": ("2012", "2012"),
    "MONTH_FRAME": ("10", "10"),
    "DAY_FRAME": ("01", "10"),
    "HOUR_FRAME": ("00:00:00", "23:59:59"),
    "N_SPLINES": 20,
}

EXP_1_VAL = {
    "SATELLITE": "envisat",
    "YEAR_FRAME": ("2012", "2012"),
    "MONTH_FRAME": ("10", "10"),
    "DAY_FRAME": ("11", "15"),
    "HOUR_FRAME": ("00:00:00", "23:59:59"),
    "N_SPLINES": 20,
}

EXP_1_TEST = {
    "SATELLITE": "envisat",
    "YEAR_FRAME": ("2012", "2012"),
    "MONTH_FRAME": ("10", "10"),
    "DAY_FRAME": ("16", "20"),
    "HOUR_FRAME": ("00:00:00", "23:59:59"),
    "N_SPLINES": 20,
}
