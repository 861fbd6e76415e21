"""The three-axis moments' contraction (``models.svgp.KronMoments`` at three
axes or more): the least time of its products from shapes, and its device
time in a traced window.

A step needs three products of Π m_i·n FMAs: the mean (μ against every
axis), ∂μ, and one n-mode product whose result gives the mean's part of
every ∂a_i. They are fp32-accurate, so their least time is that of the
six-product bf16 split, the fastest fp32-accurate route ``costs`` admits.
The bytes they need are μ read by the forward and by the backward and ∂μ
written; the axes' (m_i, n) blocks are left out, as they are read anyway.
"""

from __future__ import annotations

from gpbench import costs

SPAN = "vggp.model.contract"
COUNTER = "kron_contract"   # key of ops.cell_kuf.SHAPE_LAUNCHES: (name, Π m_i, n)
PRODUCTS = 3


def fmas(m_total: int, n: int) -> float:
    """FMAs of one step's contraction at Π m_i = ``m_total`` and n points."""
    return PRODUCTS * float(m_total) * n


def bound_s(m_total: int, n: int) -> float:
    """Least time (s) of one step's contraction: its operations at the bf16x6
    peak, or μ read twice and ∂μ written over HBM, whichever is larger."""
    t_ops = 2.0 * fmas(m_total, n) / costs.PEAKS["bf16x6"]
    t_bytes = 3 * m_total * costs.F4 / costs.HBM_BYTES_PER_S
    return max(t_ops, t_bytes)


def window_bound_s(shape_launches) -> float:
    """Least time (s) of every contraction counted in ``shape_launches``."""
    return sum(count * bound_s(m, n)
               for (name, m, n), count in shape_launches.items() if name == COUNTER)


def device_s(rec: dict, kind: str):
    """Device seconds of the traced window's operations launched inside the
    ``vggp.model.contract`` span, or None where the window has no such span
    (another cell, no trace, a program without it)."""
    t = rec.get("trace") if rec.get("kind") == kind else None
    if t is None or not t["units"] or SPAN not in t.get("spans", {}).get("count", {}):
        return None
    return t["spans"]["device_s"].get(SPAN, 0.0)
