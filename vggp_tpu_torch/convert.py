"""Carry parameter trees between the JAX package and the port.

Both packages use the same trees: ``{"axes": ({"variance", "lengthscale"},
…), "noise"}``, which the collapsed and exact GPs take as they are. A point
feature's axis adds its inducing locations ``"z"``; a coregion axis holds
``{"w", "kappa"}`` in place of σ² and ℓ; ``"noise"`` and a learned
``"mean"`` are scalars or, per output, (P,) vectors; a sum of kernels holds
``{"components": ({"axes": …}, …), "noise"[, "mean"]}``; the free-point
model adds its (m, d) points ``"z"`` at the top level; the SVGP adds
``"q"``, ``{"mu", "raw_L"}`` for the full variational family and
``{"mu", "raw_L1", "raw_L2", …}`` for the Kronecker one. Across the
boundary the leaves are numpy arrays (``numpy.asarray`` of a JAX tree gives
them), so the port never imports JAX; feature objects are not part of the
tree and are built on each side from the same numpy arguments.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from vggp_tpu_torch import config
from vggp_tpu_torch.train import tree_map


def params_from_jax(params_np: Dict, device=None, dtype=None) -> Dict:
    """A tree of numpy arrays → the same tree of tensors on ``device``
    (``cuda`` unless given). ``dtype`` None keeps each array's dtype."""
    device = config.resolve_device(device)
    return tree_map(lambda v: torch.as_tensor(np.asarray(v), dtype=dtype, device=device),
                    params_np)


def params_to_numpy(params: Dict) -> Dict:
    """A tree of tensors → the same tree of numpy arrays (host copies)."""
    return tree_map(lambda v: v.detach().cpu().numpy(), params)


def laplace_state_from_jax(state_np: Dict, params_like: Dict, device=None, dtype=None):
    """A JAX ``LaplaceState``'s arrays (``{"mean", "chol_cov", "logdet_h"}``
    as numpy, ``numpy.asarray`` of each field) → the port's
    ``hyperpost.LaplaceState`` on ``device`` (``cuda`` unless given), its
    ``unravel`` built from ``params_like``, a parameter tree of the same
    structure (the flat order is ``ravel_pytree``'s in both packages)."""
    from vggp_tpu_torch import hyperpost
    from vggp_tpu_torch.train import ravel

    device = config.resolve_device(device)
    t = {k: torch.as_tensor(np.asarray(state_np[k]), dtype=dtype, device=device)
         for k in ("mean", "chol_cov", "logdet_h")}
    _, unravel = ravel(tree_map(lambda v: torch.as_tensor(v, device=device), params_like))
    return hyperpost.LaplaceState(mean=t["mean"], chol_cov=t["chol_cov"],
                                  logdet_h=t["logdet_h"], unravel=unravel)
