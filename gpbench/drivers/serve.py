"""Back-to-back warm posterior requests: one caller that waits for each
answer. A request is ``query_points`` fresh points scattered uniformly over
the domain, drawn from the seed and the request's index before its clock
starts; its latency runs from the call to the ``synchronize()`` that ends
it; its answer is the posterior mean and variance at every point.

Set-up makes the parameters from the seed, builds the program's warm state once, and serves
``warm_units`` requests. The check takes a sample of the window's requests,
drawn from the seed (``check_requests`` indices below ``check_within``),
with the window's last request, and holds each answer against the
reference's posterior at the same points.
"""

from __future__ import annotations

import random
import time

import torch

from gpbench import compare, data
from gpbench.reference.precision import REFERENCE, exact_products

_WARM_INDEX = 1 << 40     # warm-up requests draw from indices no window reaches


def queries(cell, k: int) -> torch.Tensor:
    g = data.generator(cell.device, cell.seed, "query", k)
    return data.points(cell.traffic["query_points"], cell.cfg["domain"], g, cell.device)


def setup(cell) -> dict:
    fam, cfg, tr = cell.family, cell.cfg, cell.traffic
    phases = data.Phases(cell.device)
    p = fam.served_params(cfg, cell.device, cell.seed)
    phases.mark("data")
    request = fam.program_serve(cfg, p)
    phases.mark("precompute")
    rng = random.Random(cell.seed)
    st = {"cell": cell, "phases": phases.seconds, "p": p,
          "request": request, "sample": set(rng.sample(range(tr["check_within"]),
                                                        tr["check_requests"])),
          "kept": {}, "last": None, "bad": torch.zeros((), dtype=torch.int64,
                                                      device=cell.device)}
    for j in range(tr["warm_units"]):
        _serve(st, _WARM_INDEX + j)
        phases.mark(f"warm{j + 1}")
    st["kept"], st["last"] = {}, None
    st["bad"].zero_()
    return st


def _serve(st: dict, k: int) -> tuple:
    """(points, seconds) of request ``k``: its points drawn, then the call
    timed to the ``synchronize()`` that ends it."""
    xs = queries(st["cell"], k)
    if xs.is_cuda:
        torch.cuda.synchronize(xs.device)
    t0 = time.perf_counter()
    mean, var = st["request"](xs)
    if mean.is_cuda:
        torch.cuda.synchronize(mean.device)
    t1 = time.perf_counter()
    st["bad"] += (~(torch.isfinite(mean).all() & torch.isfinite(var).all())).long()
    if k in st["sample"]:
        st["kept"][k] = (mean, var)
    st["last"] = (k, mean, var)
    return xs.shape[0], t1 - t0


def unit(st: dict, k: int) -> tuple:
    """(points, seconds) of request ``k`` of the window."""
    return _serve(st, k)


def failed(st: dict) -> int:
    return int(st["bad"])


def release(st: dict) -> None:
    st.pop("request", None)


def fmas(st: dict) -> dict:
    cell = st["cell"]
    return cell.family.serve_fmas(cell.cfg, cell.traffic["query_points"])


def answers(st: dict) -> dict:
    """The kept answers by request index, the window's last among them."""
    kept = dict(st["kept"])
    if st["last"] is not None:
        k, mean, var = st["last"]
        kept[k] = (mean, var)
    return kept


def reference_answer(st: dict, k: int, prec) -> tuple:
    cell = st["cell"]
    p = {key: ([t.double() for t in v] if isinstance(v, list) else v.double())
         for key, v in st["p"].items()}
    with exact_products():
        return cell.family.reference.posterior(cell.cfg, p, queries(cell, k), prec,
                                               cell.traffic["check_block"])


def check(st: dict) -> dict:
    worst = {"mean": 0.0, "var": 0.0}
    kept = answers(st)
    if not kept:
        return {"mean": float("inf"), "var": float("inf"), "_where": {}}
    for k in sorted(kept):
        mean, var = kept[k]
        rmean, rvar = reference_answer(st, k, REFERENCE)
        worst["mean"] = max(worst["mean"], compare.field_gap(mean, rmean))
        worst["var"] = max(worst["var"], compare.field_gap(var, rvar))
    worst["_where"] = {"requests": sorted(kept)}
    return worst
