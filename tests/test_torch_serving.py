"""The port's SVGP serving heads against the JAX package.

A 2-D Kronecker model with 8×7 Matérn-1/2 cell features takes its parameters
from a numpy seed and five JAX ``fit_minibatch`` steps; they cross to the port
by ``convert.params_from_jax``. Both packages then get the same numpy inputs
in float64 on the CPU (JAX in x64, its Pallas kernels in interpret mode, as
``tests/test_pallas.py`` runs them). Heads are held at rtol 1e-9 with atol
1e-9·max|ref|, elementwise building blocks at 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vggp_tpu import config as jconfig
from vggp_tpu import kernels as jkernels
from vggp_tpu import train as jtrain
from vggp_tpu.features import CellIntegralFeature as JaxCellFeature
from vggp_tpu.features import _cell_cell_cov as jax_cell_cell_cov
from vggp_tpu.models import common as jcommon
from vggp_tpu.models import svgp as jsvgp
from vggp_tpu.ops import chol as jchol
from vggp_tpu.ops import kron as jkron

import vggp_tpu_torch
from vggp_tpu_torch import config, convert, kernels, train
from vggp_tpu_torch.features import CellIntegralFeature, _cell_cell_cov
from vggp_tpu_torch.models import common, svgp
from vggp_tpu_torch.ops import chol, kron

RTOL_HEAD = 1e-9
RTOL_BLOCK = 1e-12

_MODEL_LIMS = ((8, 0.0, 1.0), (7, -0.5, 1.5))
# serving grids: the model's own cells, and other cells over part of the box
_GRIDS = {"own": _MODEL_LIMS, "other": ((5, 0.1, 0.9), (6, -0.3, 1.2))}
KINDS = ("matern12", "matern32", "matern52", "rbf")


def _specs():
    jf = tuple(JaxCellFeature.from_lims(*lims) for lims in _MODEL_LIMS)
    tf = tuple(CellIntegralFeature.from_lims(*lims) for lims in _MODEL_LIMS)
    jspec = jsvgp.SVGPSpec(kinds=("matern12",) * 2, features=jf, num_data=200,
                           variational="kron")
    tspec = svgp.SVGPSpec(kinds=("matern12",) * 2, features=tf, num_data=200,
                          variational="kron")
    return jspec, tspec


def _grids(name):
    lims = _GRIDS[name]
    return (tuple(JaxCellFeature.from_lims(*g) for g in lims),
            tuple(CellIntegralFeature.from_lims(*g) for g in lims))


def _data(seed, n):
    rng = np.random.default_rng(seed)
    x = np.stack([rng.random(n), rng.random(n) * 2.0 - 0.5], axis=1)
    y = np.sin(6 * x[:, 0]) * np.cos(3 * x[:, 1]) + 0.1 * rng.standard_normal(n)
    return x, y


@pytest.fixture(scope="module")
def fitted():
    """Parameters from a numpy seed and five JAX Adam steps (ℓ, σ², noise,
    μ and both L factors away from their seeds), as a numpy tree."""
    jspec, _ = _specs()
    rng = np.random.default_rng(0)
    q = {"mu": 0.3 * rng.standard_normal((8, 7))}
    for i, m in ((1, 8), (2, 7)):
        q[f"raw_L{i}"] = (np.asarray(jsvgp.raw_from_chol(jnp.eye(m)))
                          + 0.05 * np.tril(rng.standard_normal((m, m))))
    p0 = {"axes": ({"variance": np.asarray(1.3), "lengthscale": np.asarray(0.2)},
                   {"variance": np.asarray(0.8), "lengthscale": np.asarray(0.3)}),
          "noise": np.asarray(0.05), "q": q}
    x, y = _data(1, 200)
    params, _ = jtrain.fit_minibatch(lambda p, xb, yb: jsvgp.loss(jspec, p, xb, yb),
                                     jax.tree.map(jnp.asarray, p0), jnp.asarray(x),
                                     jnp.asarray(y), n_iters=5, batch_size=64,
                                     learning_rate=0.05, seed=0)
    return jax.tree.map(np.asarray, params)


_POST_XS = _data(2, 40)[0]
_STATE_XS = _data(3, 40)[0]
_PRIOR_XS = _data(7, 30)[0]


@pytest.fixture(scope="module")
def jax_heads(fitted):
    """Every JAX head the tests below compare with, from one compiled
    program (the JAX side run eagerly, or compiled head by head, takes a
    minute)."""
    jspec = _specs()[0]
    grids = {name: _grids(name)[0] for name in _GRIDS}

    def run(p, x_post, x_state, x_prior):
        out = {"prior": jsvgp.prior(jspec, p, x_prior),
               "predict_y": jsvgp.predict_y(jspec, p, x_prior)}
        for full in (False, True):
            for pred in (False, True):
                out[f"posterior-{full}-{pred}"] = jsvgp.posterior(jspec, p, x_post, full_cov=full,
                                                                  predictive=pred)
        for name, grid in grids.items():
            for head in _GRID_HEADS:
                out[f"{head}-{name}"] = _grid_head(jsvgp, jspec, p, grid, head)
        out["state"] = state = jsvgp.precompute(jspec, p)
        for head in _STATE_HEADS:
            out[f"{head}-state"] = _state_head(jsvgp, jspec, p, state, head, grids["other"],
                                               x_state)
        return out

    return jax.jit(run)(jax.tree.map(jnp.asarray, fitted),
                        *(jnp.asarray(x) for x in (_POST_XS, _STATE_XS, _PRIOR_XS)))


def _both(p_np):
    return jax.tree.map(jnp.asarray, p_np), convert.params_from_jax(p_np, device="cpu",
                                                                    dtype=torch.float64)


def _close(got, want, rtol=RTOL_HEAD):
    want, got = (v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
                 for v in (want, got))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())


def _gauss_close(got, want, rtol=RTOL_HEAD):
    _close(got.mean, want.mean, rtol)
    if want.cov is not None:
        assert got.var is None
        _close(got.cov, want.cov, rtol)
    else:
        assert got.cov is None
        _close(got.var, want.var, rtol)


# --------------------------------------------------------------------------- #
# heads
# --------------------------------------------------------------------------- #

def _requiring_grad(tp):
    return train.tree_map(lambda v: v.clone().requires_grad_(), tp)


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("predictive", [False, True])
@pytest.mark.parametrize("full_cov", [False, True])
def test_posterior_matches_jax(fitted, jax_heads, full_cov, predictive, grad):
    """Cold posterior at 40 points: served under no_grad (the warm head on a
    fresh state, dense Cholesky whitening), and with gradients on (the
    scalar-tangent whitening, as the JAX package's)."""
    _, tspec = _specs()
    _, tp = _both(fitted)
    with torch.set_grad_enabled(grad):
        got = svgp.posterior(tspec, _requiring_grad(tp) if grad else tp,
                             torch.tensor(_POST_XS), full_cov=full_cov, predictive=predictive)
    assert got.mean.requires_grad == grad
    _gauss_close(got, jax_heads[f"posterior-{full_cov}-{predictive}"])


_GRID_HEADS = ["q_u", "p_v_u", "q_v", "q_v_full", "q_dv0", "q_dv1", "q_dv0_full", "q_dv1_full"]
_STATE_HEADS = ["posterior", "posterior_full", "q_v", "q_v_full", "q_dv0", "q_dv1_full"]


def _grid_head(mod, spec, p, grid, head, state=None):
    """Run one grid head of ``mod`` (the JAX package's svgp or the port's),
    from ``state`` when given."""
    full = head.endswith("_full")
    if head == "q_u":
        return mod.q_u(spec, p)
    if head == "p_v_u":
        return mod.p_v_u(spec, p, grid)
    if head.startswith("q_v"):
        if state is not None:
            return mod.q_v_from_state(spec, p, state, grid, full_cov=full)
        return mod.q_v(spec, p, grid, full_cov=full)
    axis = int(head[4])
    if state is not None:
        return mod.q_dv_from_state(spec, p, state, grid, axis, full_cov=full)
    return mod.q_dv(spec, p, grid, axis, full_cov=full)


def _state_head(mod, spec, p, state, head, grid, xs):
    if head.startswith("posterior"):
        return mod.posterior_from_state(spec, p, state, xs, full_cov=head.endswith("_full"))
    return _grid_head(mod, spec, p, grid, head, state)


@pytest.mark.parametrize("grid", sorted(_GRIDS))
@pytest.mark.parametrize("head", _GRID_HEADS)
def test_grid_heads_match_jax(fitted, jax_heads, head, grid):
    _, tspec = _specs()
    _, tp = _both(fitted)
    _, tg = _grids(grid)
    _gauss_close(_grid_head(svgp, tspec, tp, tg, head), jax_heads[f"{head}-{grid}"])


@pytest.mark.parametrize("head", _STATE_HEADS)
def test_from_state_heads_match_jax(fitted, jax_heads, head):
    """``precompute`` (its Kuu Cholesky and variational factors) and each
    ``*_from_state`` head."""
    _, tspec = _specs()
    _, tp = _both(fitted)
    jstate, tstate = jax_heads["state"], svgp.precompute(tspec, tp)
    for jc, tc in zip(jstate[0], tstate[0]):
        _close(tc.F, jc.F)
    for jl, tl in zip(jstate[1], tstate[1]):
        _close(tl, jl, RTOL_BLOCK)
    got = _state_head(svgp, tspec, tp, tstate, head, _grids("other")[1], torch.tensor(_STATE_XS))
    _gauss_close(got, jax_heads[f"{head}-state"])


@pytest.mark.parametrize("head", ["posterior", "posterior_full", "q_v", "q_dv0", "q_dv1_full"])
def test_warm_equals_cold(fitted, head):
    """The warm heads (dense Cholesky whitening) equal the cold ones within
    1e-9 in float64. The cold posterior is taken with gradients on, so it
    whitens through the closed-form F⁻¹ and the banded apply."""
    _, tspec = _specs()
    _, tp = _both(fitted)
    state = svgp.precompute(tspec, tp)
    with torch.no_grad():
        if head.startswith("posterior"):
            full = head.endswith("_full")
            xs = torch.tensor(_data(4, 300)[0])    # 300 > m_i: the explicit-inverse branch
            warm = svgp.posterior_from_state(tspec, tp, state, xs, full_cov=full)
            with torch.enable_grad():
                cold = svgp.posterior(tspec, _requiring_grad(tp), xs, full_cov=full)
        else:
            _, tg = _grids("own")
            warm = _grid_head(svgp, tspec, tp, tg, head, state)
            cold = _grid_head(svgp, tspec, tp, tg, head)
    _gauss_close(warm, cold)


@pytest.mark.parametrize("batch", [6, 64])
def test_dense_whitening_loss_and_gradients_match_jax(fitted, batch, monkeypatch):
    """``config.SCALAR_WHITEN_VJP`` off on both sides: the loss through the
    dense ``_whitened_blocks`` branch and every gradient leaf by autograd
    (rtol 1e-9). Batch 6 takes the triangular solve, 64 the explicit inverse
    and ``WhitenMatmul``."""
    monkeypatch.setattr(jconfig, "SCALAR_WHITEN_VJP", False)
    monkeypatch.setattr(config, "SCALAR_WHITEN_VJP", False)
    jspec, tspec = _specs()
    xb, yb = _data(5, batch)
    calls = []
    real = chol.WhitenMatmul.apply
    monkeypatch.setattr(chol.WhitenMatmul, "apply", lambda *a: calls.append(1) or real(*a))

    jraw = jtrain.unconstrain(jax.tree.map(jnp.asarray, fitted))
    jval, jg = jax.jit(jax.value_and_grad(
        lambda r: jsvgp.loss(jspec, jtrain.constrain(r), jnp.asarray(xb), jnp.asarray(yb))))(jraw)
    traw = train.raw_leaves_from(convert.params_from_jax(fitted, device="cpu",
                                                         dtype=torch.float64))
    tval = svgp.loss(tspec, train.constrain(traw), torch.tensor(xb), torch.tensor(yb))
    tval.backward()
    assert len(calls) == (2 if batch > 8 else 0)
    np.testing.assert_allclose(float(tval), float(jval), rtol=RTOL_HEAD)
    want = {"axes": jg["axes"], "noise": jg["noise"], "q": jg["q"]}
    got = train.tree_map(lambda v: v.grad, traw)
    for i in range(2):
        for k in ("variance", "lengthscale"):
            _close(got["axes"][i][k], want["axes"][i][k])
    _close(got["noise"], want["noise"])
    for k in want["q"]:
        _close(got["q"][k], want["q"][k])


def test_module_methods_call_the_heads(fitted):
    _, tspec = _specs()
    _, tp = _both(fitted)
    model = svgp.SVGP(tspec, tp, dtype=torch.float64, device="cpu")
    xs = torch.tensor(_data(6, 10)[0])
    with torch.no_grad():
        p = model.params()
        pairs = [(model.posterior(xs, full_cov=True), svgp.posterior(tspec, p, xs, full_cov=True)),
                 (model.q_v(), svgp.q_v(tspec, p, tspec.features)),
                 (model.q_dv(axis=1), svgp.q_dv(tspec, p, tspec.features, 1))]
        state = model.precompute()
    for got, want in pairs:
        _gauss_close(got, want, RTOL_BLOCK)
    assert len(state) == 2 and all(isinstance(c, chol.PSDFactor) for c in state[0])
    g = pairs[0][0]
    _close(g.variance(), torch.diagonal(g.cov), RTOL_BLOCK)
    _close(g.stddev(), torch.sqrt(torch.diagonal(g.cov)), RTOL_BLOCK)


def test_prior_and_predict_y_match_jax(fitted, jax_heads):
    _, tspec = _specs()
    _, tp = _both(fitted)
    xs = torch.tensor(_PRIOR_XS)
    _gauss_close(svgp.prior(tspec, tp, xs), jax_heads["prior"])
    with torch.no_grad():
        _gauss_close(svgp.predict_y(tspec, tp, xs), jax_heads["predict_y"])


# --------------------------------------------------------------------------- #
# building blocks
# --------------------------------------------------------------------------- #

def test_kron_blocks_match_jax():
    rng = np.random.default_rng(8)
    mats = [rng.standard_normal(s) for s in ((3, 4), (2, 5), (4, 2))]
    _close(kron.kron_dense([torch.tensor(m) for m in mats]),
           jkron.kron_dense([jnp.asarray(m) for m in mats]), RTOL_BLOCK)
    a, b = rng.standard_normal((3, 7)), rng.standard_normal((4, 7))
    _close(kron.khatri_rao_rows(torch.tensor(a), torch.tensor(b)),
           jkron.khatri_rao_rows(jnp.asarray(a), jnp.asarray(b)), RTOL_BLOCK)
    diags = [rng.standard_normal(n) for n in (3, 5, 2)]
    _close(kron.kron_diag([torch.tensor(d) for d in diags]),
           jkron.kron_diag([jnp.asarray(d) for d in diags]), RTOL_BLOCK)


@pytest.mark.parametrize("cols", [5, 40])
def test_psd_factor_whiten_matches_jax(cols):
    """Both branches of ``cols > m`` of the Cholesky factor on a 12×12
    Matérn-1/2 cell Gram (rtol 1e-9: a triangular solve or an explicit
    inverse of a Gram with condition ~1e3)."""
    feat = JaxCellFeature.from_lims(12, 0.0, 1.0)
    kuu = np.asarray(feat.Kuu("matern12", {"variance": jnp.asarray(1.1),
                                           "lengthscale": jnp.asarray(0.4)}))
    b = np.random.default_rng(9).standard_normal((12, cols))
    jf = jchol.psd_factor(jnp.asarray(kuu), method="chol")
    tf = chol.psd_factor(torch.tensor(kuu))
    _close(tf.F, jf.F, RTOL_HEAD)
    _close(tf.whiten(torch.tensor(b)), jf.whiten(jnp.asarray(b)), RTOL_HEAD)


def test_tri_solve_matches_jax():
    rng = np.random.default_rng(10)
    L = np.tril(rng.standard_normal((6, 6))) + 4.0 * np.eye(6)
    for b in (rng.standard_normal((6, 3)), rng.standard_normal(6)):
        _close(chol.tri_solve(torch.tensor(L), torch.tensor(b)),
               jchol.tri_solve(jnp.asarray(L), jnp.asarray(b)), RTOL_BLOCK)


@pytest.mark.parametrize("ell", [0.004, 0.37, 30.0])
def test_cell_cell_cov_and_kvu_match_jax(ell):
    """The compensated Matérn-1/2 cell/cell covariance on a non-uniform
    against a uniform mesh, and ``Kvu``, from ℓ far below a cell width to
    far above the box."""
    kind = "matern12"
    rng = np.random.default_rng(11)
    mesh_a = np.sort(rng.random(9)) * 2.0 - 0.5
    mesh_b = np.linspace(0.0, 1.0, 13)
    _close(_cell_cell_cov(kind, torch.tensor(mesh_a), torch.tensor(mesh_b),
                          *(torch.tensor(a, dtype=torch.float64) for a in (1.3, ell))),
           jax_cell_cell_cov(kind, jnp.asarray(mesh_a), jnp.asarray(mesh_b), 1.3, ell), RTOL_BLOCK)
    tp = {"variance": torch.tensor(1.3, dtype=torch.float64),
          "lengthscale": torch.tensor(ell, dtype=torch.float64)}
    jp = {"variance": jnp.asarray(1.3), "lengthscale": jnp.asarray(ell)}
    grid_t, grid_j = CellIntegralFeature.from_lims(6, -0.2, 0.9), JaxCellFeature.from_lims(6, -0.2, 0.9)
    _close(CellIntegralFeature(mesh_b).Kvu(kind, tp, grid_t),
           JaxCellFeature(mesh_b).Kvu(kind, jp, grid_j), RTOL_BLOCK)


@pytest.mark.parametrize("kind", KINDS)
def test_kdiff0_face_diff_gram_and_gram_match_jax(kind):
    r = np.concatenate([np.linspace(-3.0, 3.0, 121), np.logspace(-7, 0, 29)])
    v, ell = 0.9, 0.45
    _close(kernels.kdiff0(kind, torch.tensor(r), v, ell),
           jkernels.kdiff0(kind, jnp.asarray(r), v, ell), RTOL_BLOCK)
    grid_t, grid_j = CellIntegralFeature.from_lims(9, 0.0, 0.3), JaxCellFeature.from_lims(9, 0.0, 0.3)
    tp = {"variance": torch.tensor(v, dtype=torch.float64),
          "lengthscale": torch.tensor(ell, dtype=torch.float64)}
    jp = {"variance": jnp.asarray(v), "lengthscale": jnp.asarray(ell)}
    _close(common._face_diff_gram(kind, tp, grid_t),
           jcommon._face_diff_gram(kind, jp, grid_j), RTOL_BLOCK)
    x1, x2 = np.linspace(-1.0, 1.0, 7), np.linspace(-0.3, 2.0, 5)
    _close(kernels.axis_gram(kind, tp, torch.tensor(x1), torch.tensor(x2)),
           jkernels.axis_gram(kind, jp, jnp.asarray(x1), jnp.asarray(x2)), RTOL_BLOCK)
