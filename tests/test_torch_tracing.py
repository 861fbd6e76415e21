"""The port's ``vggp.*`` spans (``vggp_tpu_torch.tracing``) and the
benchmark's attribution of a trace to them (``gpbench.spans``), on the CPU.

- With no profiler recording, a span never enters ``record_function``.
- Under the CPU profiler, a ``make_step_fn`` step of the Kronecker SVGP at 256
  cells an axis (the band gate's least size) gives its span tree, with two
  ``band_gate`` reads and one ``guarded_update`` read a step; a warm
  ``posterior_from_state`` gives its spans and no read.
- The attribution on synthetic events: a kernel through its launch, one
  launched on the autograd thread through the backward node's sequence
  number, one with no span, an idle interval split between two spans.
- ``spans.install`` adds the key ``spans`` to ``trace.summarize``'s summary and
  leaves its other keys as they were; the spans move none of those keys but
  the names of ``idle_gaps``, where the host sat inside a span between
  operators.
"""

import collections
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from gpbench import spans as sp
from gpbench import trace
from vggp_tpu_torch import CellIntegralFeature, SVGPSpec, tracing, train
from vggp_tpu_torch.models import svgp

M, BATCH = 256, 32

STEP_SPANS = {"vggp.entry.step": 1, "vggp.entry.backward": 1, "vggp.entry.update": 1,
              "vggp.sync.guarded_update": 1, "vggp.sync.band_gate": 2,
              "vggp.model.moments": 1, "vggp.model.likelihood": 1, "vggp.model.kl": 1,
              "vggp.dispatch.finv": 2, "vggp.dispatch.kuf": 2, "vggp.dispatch.whiten": 2,
              "vggp.dispatch.tangent": 8}
POSTERIOR_SPANS = {"vggp.entry.posterior": 1, "vggp.dispatch.kuf": 2,
                   "vggp.dispatch.whiten": 2, "vggp.model.moments": 1,
                   "vggp.model.likelihood": 1}
# a span's innermost enclosing span, where it is not the unit's own
PARENT = {"vggp.sync.band_gate": "vggp.dispatch.whiten",
          "vggp.sync.guarded_update": "vggp.entry.update"}


def _model():
    feats = tuple(CellIntegralFeature.from_lims(M, 0.0, 1.0) for _ in range(2))
    spec = SVGPSpec(kinds=("matern12", "matern12"), features=feats, num_data=10_000,
                    variational="kron")
    model = svgp.SVGP(spec, device=torch.device("cpu"))
    g = torch.Generator().manual_seed(19)
    X = torch.rand(BATCH, 2, generator=g)
    y = torch.sin(6.0 * X[:, 0]) * torch.cos(5.0 * X[:, 1])
    return spec, model, X, y


def _step_fn(spec, model):
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    return train.make_step_fn(lambda q, xb, yb: svgp.loss(spec, q, xb, yb),
                              model.raw_params(), opt)


def _posterior_fn(spec, model):
    params = model.params()
    with torch.no_grad():
        state = svgp.precompute(spec, params)

    def request(X):
        with torch.no_grad():
            return svgp.posterior_from_state(spec, params, state, X)

    return request


UNITS = {"step": (_step_fn, STEP_SPANS), "posterior": (_posterior_fn, POSTERIOR_SPANS)}


def _traced(unit: str, n: int = 2):
    """The raw events of ``n`` units (after one untraced) in a profiled
    window marked as the benchmark marks it."""
    spec, model, X, y = _model()
    make, _ = UNITS[unit]
    fn = make(spec, model)
    args = (X, y) if unit == "step" else (X,)
    fn(*args)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(trace.MARKER):
            for _ in range(n):
                fn(*args)
    return prof.profiler.kineto_results.events()


def _prof(events):
    """What ``trace.summarize`` reads of a profiler, around ``events``."""
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))


def _plain(events) -> dict:
    """``trace.summarize`` as the benchmark's own module has it."""
    return getattr(trace.summarize, "__wrapped__", trace.summarize)(_prof(events))


@pytest.fixture
def summarize(monkeypatch):
    """``trace.summarize`` with ``spans.install``, over raw events."""
    monkeypatch.setattr(trace, "summarize", trace.summarize)
    sp.install()
    return lambda events: trace.summarize(_prof(events))


def _vggp(events):
    return sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                  for e in events if e.name().startswith("vggp."))


@pytest.mark.parametrize("unit", sorted(UNITS))
def test_no_profiler_no_record_function(monkeypatch, unit):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert tracing.span("vggp.entry.step") is tracing.span("vggp.model.kl")
    spec, model, X, y = _model()
    fn = UNITS[unit][0](spec, model)
    out = fn(X, y) if unit == "step" else fn(X).mean
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("unit", sorted(UNITS))
def test_span_tree_of_a_unit(unit):
    n = 2
    spans = _vggp(_traced(unit, n))
    assert collections.Counter(name for _, _, name in spans) == {
        k: n * v for k, v in UNITS[unit][1].items()}
    root = "vggp.entry.step" if unit == "step" else "vggp.entry.posterior"
    stack = []
    for s, t, name in spans:
        while stack and stack[-1][1] <= s:
            stack.pop()
        parent = stack[-1][2] if stack else None
        assert parent == (None if name == root else PARENT.get(name, root)), (name, parent)
        stack.append((s, t, name))


def test_summary_counts_the_reads_a_step(summarize):
    summary = summarize(_traced("step", 3))
    count = summary["spans"]["count"]
    assert sum(v for k, v in count.items() if k.startswith("vggp.sync.")) == 9
    rec = {"kind": "fit", "trace": dict(summary, units=3)}
    assert sp.syncs_per_unit(rec, "fit") == 3.0
    # no device: every device metric reads 0, not nothing
    for layer in ("model", "dispatch", None):
        assert sp.layer_ms_per_unit(rec, "fit", "device_s", layer) == 0.0
    idle = summary["spans"]["idle_s"]
    assert {"vggp.model.moments", "vggp.dispatch.finv", "vggp.entry.update"} <= set(idle)
    assert sum(idle.values()) == pytest.approx(summary["window_s"], rel=1e-9)


def test_backward_nodes_go_to_their_forward_spans(summarize):
    """On the CPU the backward runs inside ``vggp.entry.backward``; the
    nodes' time goes to the spans of their forward operators."""
    events = _traced("step", 3)
    backward = sum(e.duration_ns() for e in events if e.name() == "vggp.entry.backward")
    idle = summarize(events)["spans"]["idle_s"]
    assert idle["vggp.entry.backward"] < 0.5 * backward / 1e9


def test_without_spans_the_metrics_read_nothing(summarize):
    """A trace of a program with no ``vggp.*`` span gives no span metric."""
    events = [e for e in _traced("step", 1) if not e.name().startswith("vggp.")]
    rec = {"kind": "fit", "trace": dict(summarize(events), units=1)}
    assert sp.syncs_per_unit(rec, "fit") is None
    assert sp.layer_ms_per_unit(rec, "fit", "device_s", "model") is None


UNMOVED = ("busy_s", "window_s", "launches", "kernel_s", "device_ops")


@pytest.mark.parametrize("unit", sorted(UNITS))
def test_summary_keys_read_the_same_with_spans(unit, summarize):
    """``install`` adds ``spans`` and leaves every other key as
    ``trace.summarize`` gives it; the same trace less its spans reads the same
    in those keys, but that an idle interval the host spent inside a span,
    between operators, is named by the span."""
    events = _traced(unit)
    plain = _plain(events)
    with_spans = summarize(events)
    assert set(with_spans) == set(plain) | {"spans"}
    for key in plain:
        assert with_spans[key] == plain[key], key
    without = _plain([e for e in events if not e.name().startswith("vggp.")])
    assert set(without) == set(plain)
    for key in UNMOVED:
        assert plain[key] == without[key], key
    assert [v for _, v in plain["idle_gaps"]] == [v for _, v in without["idle_gaps"]]
    for (a, _), (b, _) in zip(plain["idle_gaps"], without["idle_gaps"]):
        assert a == b or a.startswith("vggp."), (a, b)
    stripped = [e for e in events if not e.name().startswith("vggp.")]
    assert with_spans["spans"]["count"] and not summarize(stripped)["spans"]["count"]


def test_install_wraps_once(monkeypatch):
    monkeypatch.setattr(trace, "summarize", trace.summarize)
    plain = getattr(trace.summarize, "__wrapped__", trace.summarize)
    sp.install()
    wrapped = trace.summarize
    sp.install()
    assert trace.summarize is wrapped and wrapped.__wrapped__ is plain


def test_summary_keys_of_a_run_without_spans(monkeypatch, summarize):
    """Two runs, the spans silenced in one: the same keys, the same counts."""
    on = summarize(_traced("step"))
    monkeypatch.setattr(tracing, "_profiler_enabled", lambda: False)
    off = summarize(_traced("step"))
    assert set(on) == set(off)
    for key in ("busy_s", "launches", "kernel_s", "device_ops"):
        assert on[key] == off[key], key
    assert not off["spans"]["count"]


# --------------------------------------------------------------------------- #
# the attribution on synthetic events
# --------------------------------------------------------------------------- #

MAIN, AUTOGRAD = 1, 2


def _ev(name, tid, start, end, seq=-1, fwd_tid=0):
    return sp.HostEvent(name, tid, start, end, seq, fwd_tid)


# (events, calls, device, gaps, expected device ns by span, expected idle ns by span)
CASES = {
    "launch": (
        [_ev("vggp.entry.step", MAIN, 0, 1000), _ev("vggp.dispatch.kuf", MAIN, 100, 200)],
        {7: (MAIN, 150), 8: (MAIN, 300)},
        [(400, 410, "cell_kuf", 7), (410, 430, "gemm", 8)],
        [],
        {"vggp.dispatch.kuf": 10, "vggp.entry.step": 20}, {}),
    "autograd_thread": (
        [_ev("vggp.entry.step", MAIN, 0, 1000),
         _ev("vggp.model.moments", MAIN, 100, 200),
         _ev("KronMoments", MAIN, 120, 180, seq=41),
         _ev("aten::mm", MAIN, 130, 140, seq=41),
         _ev("aten::mul", MAIN, 300, 310, seq=42),
         _ev("vggp.entry.backward", MAIN, 400, 900),
         _ev(f"{sp.BACKWARD}: KronMomentsBackward", AUTOGRAD, 500, 600, seq=41, fwd_tid=MAIN),
         _ev("KronMomentsBackward", AUTOGRAD, 501, 599, seq=41, fwd_tid=MAIN),
         _ev(f"{sp.BACKWARD}: MulBackward0", AUTOGRAD, 650, 700, seq=42, fwd_tid=MAIN)],
        {1: (AUTOGRAD, 550), 2: (AUTOGRAD, 660), 3: (AUTOGRAD, 620)},
        [(560, 600, "sgemm", 1), (670, 675, "mul", 2), (630, 640, "add", 3)],
        [(600, 630)],
        {"vggp.model.moments": 40, "vggp.entry.step": 5, "vggp.entry.backward": 10},
        {"vggp.entry.backward": 30}),
    "no_span": (
        [_ev("vggp.entry.step", MAIN, 0, 100)],
        {5: (MAIN, 150), 6: (AUTOGRAD, 50)},
        [(160, 170, "index", 5), (170, 175, "add", 6), (175, 180, "memset", 99)],
        [(100, 160)],
        {sp.UNATTRIBUTED: 15, "vggp.entry.step": 5}, {sp.UNATTRIBUTED: 60}),
    "idle_split": (
        [_ev("vggp.entry.step", MAIN, 0, 200), _ev("vggp.model.kl", MAIN, 10, 50),
         _ev("vggp.dispatch.finv", MAIN, 50, 120),
         _ev("vggp.sync.band_gate", MAIN, 60, 80)],
        {9: (MAIN, 70)},
        [(70, 75, "memcpy", 9)],
        [(30, 70), (75, 130)],
        {"vggp.dispatch.finv": 5},
        {"vggp.model.kl": 20, "vggp.dispatch.finv": 65, "vggp.entry.step": 10}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_attribution(case):
    events, calls, device, gaps, want_device, want_idle = CASES[case]
    got = sp.attribute(events, calls, device, gaps, (0, 10_000))
    assert got["device_s"] == pytest.approx({k: v / 1e9 for k, v in want_device.items()})
    assert got["idle_s"] == pytest.approx({k: v / 1e9 for k, v in want_idle.items()})


def test_reads_inside_sync_spans_are_counted():
    events = [_ev("vggp.entry.step", MAIN, 0, 100), _ev("vggp.sync.band_gate", MAIN, 10, 20),
              _ev("vggp.sync.guarded_update", MAIN, 50, 60)]
    syncs = [(MAIN, 15), (MAIN, 55), (MAIN, 90), (MAIN, 150)]
    got = sp.attribute(events, {}, [], [], (0, 200), syncs)
    assert got["count"] == {"vggp.entry.step": 1, "vggp.sync.band_gate": 1,
                            "vggp.sync.guarded_update": 1}
    assert got["runtime_syncs"] == {"in_units": 3, "in_sync_spans": 2}
