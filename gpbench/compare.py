"""The numbers that decide ``correct``, each a gap between what the program
produced and what the reference works out, relative to the reference."""

from __future__ import annotations

import math
import statistics

import torch


def _norm(t) -> float:
    return 0.0 if t is None else float(torch.linalg.vector_norm(t.double()))


def rel_gap(got: float, want: float) -> float:
    """|got − want| / |want|; a number that is not finite is an infinite gap."""
    if not (math.isfinite(got) and math.isfinite(want)):
        return math.inf
    return abs(got - want) / max(abs(want), 1e-300)


def loss_gap(got: list, want: list) -> float:
    """The worst step's relative gap of the loss."""
    if len(got) != len(want):
        return math.inf
    return max(rel_gap(float(g), float(w)) for g, w in zip(got, want))


def leaf_norm_gap(got: dict, want: dict, names=None) -> tuple:
    """(gap, leaf) of the worst leaf: |‖got‖ − ‖want‖| over the larger of
    that leaf's ‖want‖ and the median leaf's, over ``names`` (all leaves of
    ``want`` by default). A leaf the program left without a value reads
    norm 0."""
    names = list(want) if names is None else list(names)
    ref = {k: _norm(want[k]) for k in want}
    med = statistics.median(ref.values())
    worst, at = 0.0, None
    for k in names:
        g = _norm(got.get(k))
        if not (math.isfinite(g) and math.isfinite(ref[k])):
            return math.inf, k
        scale = max(ref[k], med)
        gap = abs(g - ref[k]) / scale if scale > 0 else (0.0 if g == 0 else math.inf)
        if gap >= worst:
            worst, at = gap, k
    return worst, at


def moved_leaves(grad_ref: dict, rel: float = 1e-3) -> list:
    """The leaves whose reference gradient is at least ``rel`` of the median
    leaf's: the others are nought to rounding and move under Adam by
    round-off alone."""
    norms = {k: _norm(v) for k, v in grad_ref.items()}
    med = statistics.median(norms.values())
    return [k for k, v in norms.items() if v >= rel * med]


def field_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """max|got − want| / max|want| over a served field."""
    if got is None or got.shape != want.shape:
        return math.inf
    got, want = got.double(), want.double()
    if not bool(torch.isfinite(got).all()):
        return math.inf
    return float(torch.max(torch.abs(got - want)) / torch.max(torch.abs(want)))


def named_leaves(tree, prefix: str = "") -> dict:
    """The tensors of a nested dict/tuple tree by dotted path."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(named_leaves(v, f"{prefix}{k}."))
        return out
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, v in enumerate(tree):
            out.update(named_leaves(v, f"{prefix}{i}."))
        return out
    return {prefix[:-1]: tree}
