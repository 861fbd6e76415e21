"""The rest of the port's ``train`` (``vggp_tpu/train.py:289-588``) against
the JAX package: the restarts, ``fit_lbfgs`` (optax's L-BFGS and zoom line
search, ported in ``vggp_tpu_torch/lbfgs.py``), the checkpoints,
``MetricsLogger`` and ``profile_trace``.

Float64 on the CPU, JAX in x64 with its Pallas kernels in interpret mode.
Trajectories are held at rtol 1e-8: the restarts' Adam histories, and
L-BFGS over 30 iterations, flatline included. Draws are patched to one
numpy table in both packages, keyed as JAX folds its key.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vggp_tpu import train as jtrain
from vggp_tpu.features import CellIntegralFeature as JaxCellFeature
from vggp_tpu.models import exact as jexact
from vggp_tpu.models import sgpr as jsgpr

from vggp_tpu_torch import convert, sampling, train
from vggp_tpu_torch.features import CellIntegralFeature
from vggp_tpu_torch.models import exact, sgpr

RTOL_TRAJ = 1e-8


def _data(n=60, seed=0):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.random(n))
    return x, np.sin(6 * x) + 0.1 * rng.standard_normal(n)


def _collapsed(m=8):
    """(JAX loss, port loss, JAX base init as numpy) of a 1-D collapsed
    GriddedGP on m Matérn-1/2 cells."""
    x, y = _data()
    jx, jy, tx, ty = jnp.asarray(x), jnp.asarray(y), torch.tensor(x), torch.tensor(y)
    js = jsgpr.SGPRSpec(kinds=("matern12",), features=(JaxCellFeature.from_lims(m, 0.0, 1.0),))
    ts = sgpr.SGPRSpec(kinds=("matern12",), features=(CellIntegralFeature.from_lims(m, 0.0, 1.0),))
    p0 = jtrain.non_informative_init(js.init_params(jnp.float64), jx, jy)
    return (lambda q: jsgpr.loss(js, q, jx, jy), lambda q: sgpr.loss(ts, q, tx, ty),
            jax.tree.map(np.asarray, p0))


def _exact():
    x, y = _data(40, 3)
    jx, jy, tx, ty = jnp.asarray(x), jnp.asarray(y), torch.tensor(x), torch.tensor(y)
    js, ts = jexact.ExactGPSpec(kinds=("matern32",)), exact.ExactGPSpec(kinds=("matern32",))
    p0 = jtrain.non_informative_init(js.init_params(jnp.float64), jx, jy)
    return (lambda q: jexact.loss(js, q, jx, jy), lambda q: exact.loss(ts, q, tx, ty),
            jax.tree.map(np.asarray, p0))


def _to_torch(p_np):
    return convert.params_from_jax(p_np, device="cpu", dtype=torch.float64)


def _close(got, want, rtol=RTOL_TRAJ):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())


def _leaves_close(got_tree, want_tree, rtol=RTOL_TRAJ):
    for g, w in zip(train.sorted_leaves(got_tree), jax.tree.leaves(want_tree), strict=True):
        _close(g, w, rtol)


def _patch_restart_draws(monkeypatch, key, shapes, seed=5):
    """JAX's ``init_restarts`` draws leaf i from ``fold_in(key, i)``; the
    port's i-th draw is leaf i in the same (sorted) order. Both get row i
    of one numpy table."""
    rng = np.random.default_rng(seed)
    table = [rng.standard_normal(s) for s in shapes]
    keys = np.stack([np.asarray(jax.random.fold_in(key, i)) for i in range(len(shapes))])
    real = jax.random.normal

    def jnormal(k, shape=(), dtype=float):
        hit = np.flatnonzero(np.all(np.asarray(k) == keys, axis=-1))
        if not hit.size:
            return real(k, shape, dtype)
        return jnp.asarray(table[hit[0]], dtype)

    rows = iter(table)
    monkeypatch.setattr(jax.random, "normal", jnormal)
    monkeypatch.setattr(sampling, "normal",
                        lambda gen, shape, like: torch.as_tensor(next(rows), dtype=like.dtype))


def test_init_restarts_contract_and_draws_match_jax(monkeypatch):
    """``init_restarts``: every leaf grows a leading restart axis, restart 0
    is the base init verbatim, the others positive and distinct, the same
    generator seed gives the same starts; with both packages' draws patched
    to one table the batch equals JAX's exactly (the leaves drawn in JAX's
    sorted order)."""
    _, _, p0 = _collapsed()
    tp0 = _to_torch(p0)
    pb = train.init_restarts(tp0, torch.Generator().manual_seed(0), 5, spread=0.7)
    for a, b in zip(train.tree_leaves(pb), train.tree_leaves(tp0), strict=True):
        assert a.shape == (5,) + b.shape
        assert torch.equal(a[0], b)
    assert torch.all(pb["noise"] > 0) and len(torch.unique(pb["noise"])) == 5
    pb2 = train.init_restarts(tp0, torch.Generator().manual_seed(0), 5, spread=0.7)
    assert torch.equal(pb["axes"][0]["lengthscale"], pb2["axes"][0]["lengthscale"])
    assert list(pb["axes"][0]) == list(tp0["axes"][0])       # key order kept
    key = jax.random.PRNGKey(1)
    _patch_restart_draws(monkeypatch, key, [(4,)] * 3)
    jb = jtrain.init_restarts(jax.tree.map(jnp.asarray, p0), key, 4, spread=0.8)
    tb = train.init_restarts(tp0, torch.Generator(), 4, spread=0.8)
    _leaves_close(tb, jb, 1e-15)


def test_fit_restarts_match_jax_and_sequential_fits():
    """``fit_restarts`` on JAX's ``params_batch`` (4 restarts, 40 Adam steps):
    every history entry (R, n_iters) at rtol 1e-8 of JAX's vmapped program,
    ``best`` JAX's index and the argmin of the final losses, the best
    parameters equal to a sequential ``fit`` of that restart."""
    jloss, tloss, p0 = _collapsed()
    jb = jtrain.init_restarts(jax.tree.map(jnp.asarray, p0), jax.random.PRNGKey(1), 4, spread=0.8)
    jbest, jhist = jtrain.fit_restarts(jloss, jb, n_iters=40, learning_rate=0.05)
    tb = _to_torch(jax.tree.map(np.asarray, jb))
    tbest, thist = train.fit_restarts(tloss, tb, n_iters=40, learning_rate=0.05)
    assert sorted(thist) == sorted(jhist)
    for k in jhist:
        if k != "best":
            assert thist[k].shape == (4, 40)
            _close(thist[k], jhist[k])
    assert thist["best"] == jhist["best"] == int(torch.argmin(thist["loss"][:, -1]))
    _leaves_close(tbest, jbest)
    seq, _ = train.fit(tloss, train.tree_map(lambda v: v[thist["best"]], tb), 40, 0.05)
    for a, b in zip(train.tree_leaves(tbest), train.tree_leaves(seq), strict=True):
        assert torch.equal(a, b)


def test_fit_restarts_counts_a_nonfinite_loss_as_worst():
    """A restart whose final loss is NaN never wins."""
    def loss_fn(p):
        v = (p["noise"] - 0.3) ** 2
        return torch.where(p["noise"] > 2.0, torch.full_like(v, float("nan")), v)

    pb = {"noise": torch.tensor([0.31, 5.0, 0.9], dtype=torch.float64)}
    _, hist = train.fit_restarts(loss_fn, pb, n_iters=3, learning_rate=0.01)
    assert torch.isnan(hist["loss"][1, -1])
    assert hist["best"] == 0


@pytest.mark.parametrize("model", ("collapsed", "exact"))
def test_fit_lbfgs_matches_optax(model):
    """``fit_lbfgs`` against ``optax.lbfgs`` through the JAX package's
    ``fit_lbfgs``: 30 iterations in float64 from the same init, every
    history entry and the final parameters at rtol 1e-8. Both converge in
    about 15 iterations, after which the history flatlines: its last 10
    losses within 1e-10 of each other in both (the steps go on at roundoff,
    ±1e-13)."""
    jloss, tloss, p0 = _collapsed() if model == "collapsed" else _exact()
    jfin, jhist = jtrain.fit_lbfgs(jloss, jax.tree.map(jnp.asarray, p0), n_iters=30)
    tfin, thist = train.fit_lbfgs(tloss, _to_torch(p0), n_iters=30)
    assert sorted(thist) == sorted(jhist)
    for k in jhist:
        _close(thist[k], jhist[k])
    _leaves_close(tfin, jfin)
    for loss in (thist["loss"].numpy(), np.asarray(jhist["loss"])):
        assert np.all(np.diff(loss) <= 1e-9 * np.abs(loss).max())   # monotone
        assert np.ptp(loss[-10:]) <= 1e-10 * np.abs(loss[-1])       # flat to roundoff


def test_lbfgs_guard_drops_a_nonfinite_iterate():
    """An iterate that is not finite everywhere is dropped with its state:
    the parameters stay put and the history flatlines, as JAX's guard."""
    def loss_fn(p):
        v = p["noise"]
        return torch.where(v > 0.5, torch.full_like(v, float("inf")), (v - 3.0) ** 2)

    fin, hist = train.fit_lbfgs(loss_fn, {"noise": torch.tensor(0.2, dtype=torch.float64)}, 5)
    assert torch.isfinite(fin["noise"]) and fin["noise"] <= 0.5
    assert torch.all(torch.isfinite(hist["loss"]))


def test_checkpoint_round_trip_from_an_orbax_checkpoint(tmp_path):
    """A JAX orbax checkpoint → numpy → ``convert`` → the port's save and
    load: bitwise equal, ``like=`` restores the tuples (without it the
    saved containers come back as saved), the step directory layout as
    JAX's."""
    grid = JaxCellFeature.from_lims(5, 0.0, 1.0)
    p = jsgpr.SGPRSpec(kinds=("matern12",), features=(grid,)).init_params(jnp.float64)
    jtrain.save_checkpoint(str(tmp_path / "jax"), p, step=3)
    restored = jtrain.load_checkpoint(str(tmp_path / "jax"), step=3, like=p)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, restored), device="cpu")
    train.save_checkpoint(str(tmp_path / "port"), tp, step=3)
    assert (tmp_path / "port" / "3").is_dir()
    like = sgpr.SGPRSpec(kinds=("matern12",), features=(CellIntegralFeature.from_lims(5, 0, 1),)
                         ).init_params(torch.float64, "cpu")
    back = train.load_checkpoint(str(tmp_path / "port"), step=3, like=like)
    assert isinstance(back["axes"], tuple) and list(back) == list(like)
    for a, b in zip(train.sorted_leaves(back), jax.tree.leaves(p), strict=True):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert a.dtype == torch.float64


def test_metrics_logger_writes_jax_bytes(tmp_path):
    """``MetricsLogger`` writes the same bytes as the JAX package's."""
    recs = [(0, dict(loss=1.5, noise=0.1)), (1, dict(loss=torch.tensor(1.2), noise=np.float64(0.09)))]
    for pkg, name in ((jtrain, "jax.jsonl"), (train, "port.jsonl")):
        log = pkg.MetricsLogger(str(tmp_path / name))
        for step, m in recs:
            log.log(step, **{k: (float(v) if pkg is jtrain else v) for k, v in m.items()})
    assert (tmp_path / "port.jsonl").read_bytes() == (tmp_path / "jax.jsonl").read_bytes()
    lines = [json.loads(line) for line in (tmp_path / "port.jsonl").read_text().splitlines()]
    assert lines[1] == {"step": 1, "loss": pytest.approx(1.2), "noise": 0.09}


def test_profile_trace_writes_a_trace_on_the_cpu(tmp_path):
    """``profile_trace`` around one loss evaluation writes a Chrome trace
    into its directory that names the operators run."""
    _, tloss, p0 = _collapsed()
    with train.profile_trace(str(tmp_path / "trace")):
        tloss(_to_torch(p0))
    files = list((tmp_path / "trace").glob("*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(str(e.get("name", "")).startswith("aten::") for e in events)
