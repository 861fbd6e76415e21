"""Inputs made from ``--seed``, on the device, in a few large calls: the
observations of a field, minibatch orders, query points, and the
parameters of a fitted model to serve.

Every stream has a generator of its own, seeded from (seed, stream, index),
so that one seed always gives the same inputs, whatever else a run draws.
"""

from __future__ import annotations

import time

import torch

_MASK = (1 << 63) - 1
STREAMS = {"data": 1, "order": 2, "query": 3, "params": 4}


def generator(device, seed: int, stream: str, index: int = 0) -> torch.Generator:
    g = torch.Generator(device=device)
    mixed = (int(seed) * 0x9E3779B97F4A7C15 + STREAMS[stream] * 0x632BE59BD9B4E019
             + int(index) * 0x85EBCA77C2B2AE63) & _MASK
    g.manual_seed(mixed)
    return g


def scalar(v, device) -> torch.Tensor:
    """A float32 0-d tensor of ``v`` on ``device``."""
    return torch.full((), float(v), dtype=torch.float32, device=device)


def points(n: int, domain, g: torch.Generator, device, dtype=torch.float32) -> torch.Tensor:
    """(n, d) points uniform over the box ``domain`` [[lo, hi], …]."""
    lo = torch.tensor([d[0] for d in domain], dtype=dtype, device=device)
    hi = torch.tensor([d[1] for d in domain], dtype=dtype, device=device)
    u = torch.rand((n, len(domain)), generator=g, device=device, dtype=dtype)
    return lo + (hi - lo) * u


def field(cfg: dict, n: int, device, seed: int) -> tuple:
    """(X, y): n points uniform over the domain and the configuration's field
    at them, y = sin(f₀x₀)·cos(f₁x₁) + noise_std·ε, ε standard normal."""
    f = cfg["field"]
    g = generator(device, seed, "data")
    X = points(n, cfg["domain"], g, device)
    eps = torch.randn((n,), generator=g, device=device, dtype=torch.float32)
    fx, fy = f["frequencies"]
    y = torch.sin(fx * X[:, 0]) * torch.cos(fy * X[:, 1]) + f["noise_std"] * eps
    return X, y


class EpochOrder:
    """Minibatches without replacement: each epoch a permutation of the N rows
    drawn from the seed, cut into ⌊N/b⌋ batches of b rows (the remainder is
    left out of that epoch). So the rows of the first ⌊N/b⌋ batches all
    differ."""

    def __init__(self, n_rows: int, batch, device, seed: int):
        self.n, self.b, self.device, self.seed = n_rows, batch, device, seed
        self.per_epoch = n_rows // batch
        self._epoch, self._perm = -1, None

    def batch(self, step: int):
        epoch, k = divmod(step, self.per_epoch)
        if epoch != self._epoch:
            g = generator(self.device, self.seed, "order", epoch)
            self._perm = torch.randperm(self.n, generator=g, device=self.device)
            self._epoch = epoch
        return self._perm[k * self.b:(k + 1) * self.b]


class Phases:
    """Seconds of each phase of a set-up, each ended by a ``synchronize()``."""

    def __init__(self, device):
        self.device, self.seconds = device, {}
        self._t = time.perf_counter()

    def mark(self, name: str) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t = time.perf_counter()
        self.seconds[name] = round(t - self._t, 6)
        self._t = t
