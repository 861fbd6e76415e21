"""Experiment layer: the notebook-equivalents (reference L3) as scripts.

The port of ``vggp_tpu/experiments/``: the same modules and public names,
each ``run()`` with the JAX package's signature and defaults plus
``device=None`` (``cuda`` unless the caller names another device), numpy
arrays and floats in its results. The CLIs write under ``results/torch/``.

- :mod:`vggp_tpu_torch.experiments.misc`      — history/CV dicts, metric rows
- :mod:`vggp_tpu_torch.experiments.plotting`  — training/posterior/grid plots
- :mod:`vggp_tpu_torch.experiments.configs`   — experiment dictionaries (nb61)
- :mod:`vggp_tpu_torch.experiments.loaders`   — ``load_gulf_stream_data``
- :mod:`vggp_tpu_torch.experiments.zoo`       — the model-zoo specs
- :mod:`vggp_tpu_torch.experiments.univariate`  — notebooks 1 & 4
- :mod:`vggp_tpu_torch.experiments.kronecker`   — notebooks 3 & 5
- :mod:`vggp_tpu_torch.experiments.simtracks`   — notebook 6
- :mod:`vggp_tpu_torch.experiments.gulfstream`  — notebooks 6 & 61
- :mod:`vggp_tpu_torch.experiments.northsea`    — notebook 7
- :mod:`vggp_tpu_torch.experiments.spacetime`   — 3-D lon × lat × time products
- :mod:`vggp_tpu_torch.experiments.poisson`     — gridded Poisson intensity
- :mod:`vggp_tpu_torch.experiments.exceedance`  — joint functionals by pathwise draws
- :mod:`vggp_tpu_torch.experiments.streaming`   — sequential pass assimilation
- :mod:`vggp_tpu_torch.experiments.velocity`    — geostrophic velocities (q(dv))
- :mod:`vggp_tpu_torch.experiments.evidence`    — Laplace-evidence kernel choice
- :mod:`vggp_tpu_torch.experiments.multioutput` — ICM cross-output transfer
- :mod:`vggp_tpu_torch.experiments.multiscale`  — sum-of-kernels scale split
- :mod:`vggp_tpu_torch.experiments.parity`      — the reference-style f64
  oracle (:mod:`~vggp_tpu_torch.experiments.torch_oracle`, CPU) beside the port
"""

from vggp_tpu_torch.experiments.misc import (
    make_training_history_dict,
    cross_validation_dict,
    evaluation_metric_row,
    check_tensors_equal,
)
from vggp_tpu_torch.experiments.configs import EXP_1_TRAIN, EXP_1_VAL, EXP_1_TEST
from vggp_tpu_torch.experiments.loaders import load_gulf_stream_data

__all__ = [
    "make_training_history_dict",
    "cross_validation_dict",
    "evaluation_metric_row",
    "check_tensors_equal",
    "EXP_1_TRAIN",
    "EXP_1_VAL",
    "EXP_1_TEST",
    "load_gulf_stream_data",
]
