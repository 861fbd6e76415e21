"""Min-max and z-score scalers on tensors (``vggp_tpu/utils/scalers.py``)."""

from __future__ import annotations

import torch


def min_max_scaling(x: torch.Tensor, min=None, max=None):
    if min is None:
        min = torch.min(x)
    if max is None:
        max = torch.max(x)
    return (x - min) / (max - min), min, max


def min_max_inverse(x: torch.Tensor, min, max):
    return x * (max - min) + min


def z_scaling(x: torch.Tensor):
    mean = torch.mean(x)
    std = torch.std(x, correction=1)
    return (x - mean) / std, mean, std


def z_inverse(x: torch.Tensor, mean, std):
    return x * std + mean
