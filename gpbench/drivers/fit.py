"""Back-to-back training steps of ``train.make_step_fn``: one caller, each
step loss, backward and the guarded Adam update; a unit is a step and its
points are its batch.

Set-up builds the step, its model and its optimizer once, drives them from
the seed through CHECKED_STEPS steps on batches whose rows all differ, then
``warm_units`` more, and hands the same object to the window. The check
follows the checked steps with the reference (:func:`gaps`): each step's
loss, the first gradient as Adam received it (read back from its first
moment), and the change of every raw leaf after the checked steps.
"""

from __future__ import annotations

import time

import torch

from gpbench import compare, data
from gpbench.reference.adam import Adam
from gpbench.reference.precision import REFERENCE, exact_products

CHECKED_STEPS = 3


def setup(cell) -> dict:
    fam, cfg, tr = cell.family, cell.cfg, cell.traffic
    phases = data.Phases(cell.device)
    X, y = data.field(cfg, cfg["num_data"], cell.device, cell.seed)
    p0 = fam.init_params(cfg, cell.device)
    phases.mark("data")
    step, leaves, opt = fam.program_fit(cfg, p0)
    phases.mark("build")
    batch = int(tr["batch"])
    order = data.EpochOrder(X.shape[0], batch, cell.device, cell.seed)
    if order.per_epoch < CHECKED_STEPS:
        raise ValueError(f"batch {batch} leaves fewer than {CHECKED_STEPS} distinct batches")
    st = {"cell": cell, "phases": phases.seconds, "X": X, "y": y, "p0": p0, "step": step,
          "order": order, "first": CHECKED_STEPS + tr["warm_units"],
          "points": batch, "losses": [], "before": [],
          "idx": [order.batch(k) for k in range(CHECKED_STEPS)],
          "bad": torch.zeros((), dtype=torch.int64, device=cell.device)}
    beta1 = opt.param_groups[0]["betas"][0]
    for k in range(CHECKED_STEPS):
        st["before"].append({name: v.detach().clone() for name, v in leaves.items()})
        st["losses"].append(float(_train(st, k)[0]))
        phases.mark(f"step{k + 1}")
        if k == 0:
            st["grad1"] = {name: (opt.state[p]["exp_avg"] / (1.0 - beta1)).clone()
                           if p in opt.state else None for name, p in leaves.items()}
    st["change"] = {k: (v.detach() - st["before"][0][k]).clone() for k, v in leaves.items()}
    for k in range(CHECKED_STEPS, st["first"]):
        _train(st, k)
    st["bad"].zero_()
    phases.mark("warm")
    return st


def _train(st: dict, j: int) -> tuple:
    """(loss, seconds) of the step on the order's batch ``j``."""
    t0 = time.perf_counter()
    ix = st["order"].batch(j)
    loss = st["step"](st["X"][ix], st["y"][ix])
    st["bad"] += (~torch.isfinite(loss)).long()
    return loss, time.perf_counter() - t0


def unit(st: dict, k: int) -> tuple:
    """(points, seconds) of step ``k`` of the window."""
    return st["points"], _train(st, st["first"] + k)[1]


def failed(st: dict) -> int:
    return int(st["bad"])


def release(st: dict) -> None:
    """Drop the program's objects, so that the reference has the card."""
    st.pop("step", None)


def fmas(st: dict) -> dict:
    cell = st["cell"]
    return cell.family.fit_fmas(cell.cfg, st["points"])


def _start(cell, p0, dtype) -> dict:
    """The reference's raw leaves at the constrained start ``p0``."""
    raw = cell.family.reference.raw_from_constrained(
        cell.cfg, {k: ([t.double() for t in v] if isinstance(v, list) else v.double())
                   for k, v in p0.items()})
    return {k: v.to(dtype) for k, v in raw.items()}


def _adam(cell) -> Adam:
    o = cell.cfg["optimizer"]
    return Adam(o["lr"], tuple(o["betas"]), o["eps"])


def reference_steps(cell, X, y, p0, idx, prec, block, updates=None) -> dict:
    """The reference in ``prec`` stepping on its own over the batches ``idx``
    from the constrained ``p0``: its losses, first gradient, raw leaves
    before each step and the change of each leaf after the steps. Only the
    first ``updates`` steps update (all by default). (What stands in the
    program's place: the control, a planted fault.)"""
    raw = _start(cell, p0, prec.dtype)
    adam = _adam(cell)
    losses, grad1, before = [], None, []
    with exact_products():
        for j, ix in enumerate(idx):
            before.append(raw)
            val, grads = cell.family.reference.loss_and_grad(cell.cfg, raw, X[ix], y[ix],
                                                             prec, block)
            losses.append(float(val))
            grad1 = grads if grad1 is None else grad1
            if updates is None or j < updates:
                raw = adam.step(raw, grads, val)
    return {"losses": losses, "grad1": grad1, "before": before,
            "change": {k: raw[k] - before[0][k] for k in raw}}


def gaps(cell, X, y, p0, idx, side: dict) -> dict:
    """The three numbers of the check: ``side`` (the program's, or what stands
    in its place) against the reference, which follows the side step by step
    from the side's own state. The first step starts where the reference's
    own does, at ``p0``; each later step is the reference's (float64) at the
    side's raw leaves before that step, as the side's parameters after the
    step before are its output. So a leaf whose gradient is nought to
    rounding, as ℓ's at μ = 0 and S = I, and which Adam moves by ±lr on its
    rounding's sign, parts no trajectories.

    loss: each step's loss; grad: the first gradient, leaf by leaf; change:
    each leaf's change after the steps against the reference's Adam over
    its own gradients at the side's states, over the leaves the reference's
    first gradient moves. A cell's limits file names the numbers it holds."""
    start = _start(cell, p0, torch.float64)
    states = [start] + [{k: v.double() for k, v in raw.items()} for raw in side["before"][1:]]
    adam, raw = _adam(cell), start
    losses, grads = [], []
    with exact_products():
        for state, ix in zip(states, idx):
            val, g = cell.family.reference.loss_and_grad(cell.cfg, state, X[ix], y[ix],
                                                         REFERENCE, cell.traffic["check_block"])
            losses.append(float(val))
            grads.append(g)
            raw = adam.step(raw, g, val)
    keep = compare.moved_leaves(grads[0])
    g, g_at = compare.leaf_norm_gap(side["grad1"], grads[0])
    c, c_at = compare.leaf_norm_gap(side["change"], {k: raw[k] - start[k] for k in raw}, keep)
    return {"loss": compare.loss_gap(side["losses"], losses), "grad": g, "change": c,
            "_where": {"grad": g_at, "change": c_at,
                       "steps": [compare.rel_gap(a, b) for a, b in zip(side["losses"], losses)]}}


def check(st: dict) -> dict:
    return gaps(st["cell"], st["X"], st["y"], st["p0"], st["idx"], st)
