"""Adam (Kingma & Ba) as the configuration states it, written out, with the
guard of the program's contract: a step whose loss or any gradient is not
finite is skipped whole, optimizer state included."""

from __future__ import annotations

import math

import torch


class Adam:
    def __init__(self, lr: float, betas, eps: float):
        self.lr, (self.b1, self.b2), self.eps = lr, betas, eps
        self.t = 0
        self.m, self.v = {}, {}

    def step(self, params: dict, grads: dict, loss) -> dict:
        """The parameters after one step from ``params`` with ``grads``."""
        finite = math.isfinite(float(loss)) and all(bool(torch.isfinite(g).all())
                                                    for g in grads.values())
        if not finite:
            return params
        self.t += 1
        bc1 = 1.0 - self.b1 ** self.t
        bc2 = 1.0 - self.b2 ** self.t
        out = {}
        for k, p in params.items():
            g = grads[k].to(p.dtype)
            self.m[k] = self.b1 * self.m.get(k, torch.zeros_like(p)) + (1.0 - self.b1) * g
            self.v[k] = self.b2 * self.v.get(k, torch.zeros_like(p)) + (1.0 - self.b2) * g * g
            denom = torch.sqrt(self.v[k]) / math.sqrt(bc2) + self.eps
            out[k] = p - (self.lr / bc1) * self.m[k] / denom
        return out
