"""The port's ``parallel`` package on gloo worlds of 2 and 4 CPU processes,
against the JAX package's unsharded functions in float64.

One spawn a mesh: ("data",) at 2 processes, ("data", "model") at (2, 2),
("data", "model1", "model2") at (1, 2, 2). The workers
(``_torch_parallel_workers.py``) import torch and the port only; this
process computes the JAX side (one jitted program a case, at the sizes of
tests/test_parallel.py) while they run, hands them numpy inputs and reads
their numpy outputs. The JAX package's own ``make_sharded_*`` are held
against its unsharded functions by tests/test_parallel.py.
"""

import functools
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from vggp_tpu import sampling as jsampling
from vggp_tpu import streaming as jstreaming
from vggp_tpu import train as jtrain
from vggp_tpu.features import CellIntegralFeature as JCell
from vggp_tpu.models import iterative as jiter
from vggp_tpu.models import sgpr as jsgpr
from vggp_tpu.models import svgp as jsvgp

import _torch_parallel_workers as workers

REPO = Path(__file__).resolve().parents[1]
WORKERS = Path(workers.__file__).resolve()

# tests/test_parallel.py's tolerances
TOL_LOSS = 1e-12
TOL_LEAF = dict(rtol=1e-8, atol=1e-10)
TOL_STATE = dict(rtol=1e-10, atol=1e-12)
TOL_QV = dict(rtol=1e-10, atol=1e-12)
TOL_CG = dict(rtol=1e-6, atol=1e-8)
TOL_PATHWISE = dict(rtol=1e-6, atol=1e-9)
PATH_SAMPLES, PATH_FEATURES = 16, 512


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _spec_and_data(n=64, cells=(6, 4)):
    """tests/test_parallel.py's Kronecker SVGP and data (numpy seed 0)."""
    rng = np.random.default_rng(0)
    X = rng.random((n, len(cells)))
    y = np.sin(5 * X[:, 0]) + 0.1 * rng.standard_normal(n)
    spec = jsvgp.SVGPSpec(kinds=("matern12",) * len(cells),
                          features=tuple(JCell.from_lims(m, 0.0, 1.0) for m in cells),
                          num_data=n, variational="kron")
    params = jtrain.non_informative_init(spec.init_params(jnp.float64), jnp.asarray(X),
                                         jnp.asarray(y))
    return spec, X, y, _np_tree(params)


# --------------------------------------------------------------------------- #
# the cases: (worker inputs, the JAX reference)
# --------------------------------------------------------------------------- #

@functools.cache
def step_reference(cells, grids=None):
    """3 steps of train.make_step_fn with optax.adam(0.05) on
    :func:`_spec_and_data`: the losses, the raw tree after steps 1 and 3,
    and with ``grids`` q_v after step 3."""
    spec, X, y, params = _spec_and_data(cells=cells)
    opt = optax.adam(0.05)
    step = jtrain.make_step_fn(lambda p, xb, yb: jsvgp.loss(spec, p, xb, yb), opt)
    raw = jtrain.unconstrain(jax.tree.map(jnp.asarray, params))
    st = opt.init(raw)
    out = {}
    for k in range(1, 4):
        raw, st, val = step(raw, st, jnp.asarray(X), jnp.asarray(y))
        out[f"loss{k}"] = np.asarray(val)
        if k in (1, 3):
            out[f"raw{k}"] = workers.flatten(_np_tree(raw))
    if grids is not None:
        g = tuple(JCell.from_lims(m, 0.0, 1.0) for m in grids)
        q = jax.jit(lambda r: jsvgp.q_v(spec, jtrain.constrain(r), g, full_cov=False))(raw)
        out["qv"] = {"mean": np.asarray(q.mean), "var": np.asarray(q.var)}
    return out


def step_case(cells, model_axes=None, grids=None):
    _, X, y, params = _spec_and_data(cells=cells)
    inp = {"cells": np.asarray(cells), "X": X, "y": y,
           **{f"params/{k}": v for k, v in workers.flatten(params).items()}}
    if model_axes is not None:
        inp["model_axes"] = np.asarray(["" if a is None else a for a in model_axes])
    if grids is not None:
        inp["grids"] = np.asarray(grids)
    return inp, lambda: step_reference(cells, grids)


def skip_case():
    """tests/test_parallel.py's step inputs with a NaN in the second
    process's rows; the reference is the JAX package's raw init."""
    inp, _ = step_case((6, 4))
    inp["y"] = inp["y"].copy()
    inp["y"][40] = np.nan
    _, _, _, params = _spec_and_data(cells=(6, 4))
    raw = workers.flatten(_np_tree(jtrain.unconstrain(jax.tree.map(jnp.asarray, params))))
    return inp, lambda: raw


def assimilate_case():
    rng = np.random.default_rng(11)
    n = 64
    X = rng.random((n, 2))
    y = np.sin(5 * X[:, 0]) + 0.1 * rng.standard_normal(n)
    noise = 0.01 + 0.1 * rng.random(n)
    spec = jsvgp.SVGPSpec(kinds=("matern12", "matern12"),
                          features=(JCell.from_lims(6, 0.0, 1.0), JCell.from_lims(4, 0.0, 1.0)),
                          num_data=n, variational="full")
    params = _np_tree(jtrain.non_informative_init(spec.init_params(jnp.float64),
                                                  jnp.asarray(X), jnp.asarray(y)))
    inp = {"X": X, "y": y, "noise": noise,
           **{f"params/{k}": v for k, v in workers.flatten(params).items()}}

    def reference():
        @jax.jit
        def both(p, X, y, noise):
            s0 = jstreaming.init_state(spec, jnp.float64)
            return (jstreaming.assimilate(spec, p, s0, X, y),
                    jstreaming.assimilate(spec, p, s0, X, y, noise=noise))

        plain, hetero = both(jax.tree.map(jnp.asarray, params), jnp.asarray(X), jnp.asarray(y),
                             jnp.asarray(noise))
        return {"plain": _np_tree(plain), "hetero": _np_tree(hetero)}

    return inp, reference


def _sgpr_inputs(cells, grids, X, y, params):
    return {"cells": np.asarray(cells), "grids": np.asarray(grids), "X": X, "y": y,
            **{f"params/{k}": v for k, v in workers.flatten(params).items()}}


def cg_case(n, lengthscale=None, noise=None):
    """tests/test_parallel.py's 16×12-cell collapsed model at n points: the
    KMS-Woodbury at n = 96, Jacobi at n = 8200 > CG_KMS_MAX_POINTS = 8192,
    where each of the 2 processes holds 4100 ≤ 8192 points. ``lengthscale``
    and ``noise`` replace the init values (ℓ = 1, σ² = 0.1, at which Jacobi
    does not reach tol 1e-12 within 4000 iterations at n = 8200; at ℓ =
    0.05, σ² = 1 it does in about 230)."""
    rng = np.random.default_rng(3)
    X = rng.random((n, 2))
    y = np.sin(4 * X[:, 0]) * X[:, 1] + 0.05 * rng.standard_normal(n)
    cells, grids = (16, 12), (6, 5)
    spec = jsgpr.SGPRSpec(kinds=("matern12", "matern12"),
                          features=tuple(JCell.from_lims(m, 0.0, 1.0) for m in cells),
                          jitter=1e-12)
    params = _np_tree(spec.init_params(jnp.float64))
    if lengthscale is not None:
        params = {"axes": tuple({**ax, "lengthscale": np.asarray(lengthscale)}
                                for ax in params["axes"]), "noise": np.asarray(noise)}
    inp = _sgpr_inputs(cells, grids, X, y, params)

    def reference():
        g = tuple(JCell.from_lims(m, 0.0, 1.0) for m in grids)

        @jax.jit
        def heads(p, X, y):
            w = jiter.solve_w(spec, p, X, y, tol=1e-12, maxiter=4000)
            return w, jiter.q_v_mean_from_w(spec, p, g, w), jiter.q_dv_mean_from_w(spec, p, g,
                                                                                   0, w)

        w, qv, qdv = heads(jax.tree.map(jnp.asarray, params), jnp.asarray(X), jnp.asarray(y))
        return {"w": np.asarray(w), "qv": np.asarray(qv), "qdv": np.asarray(qdv)}

    return inp, reference


def _pathwise_model():
    """tests/test_parallel.py's 1-D pathwise model: 20 Matérn-1/2 cells, 64
    sorted points, an 8-cell grid."""
    rng = np.random.default_rng(4)
    n = 64
    x = np.sort(rng.uniform(size=n))
    y = np.sin(6 * x) + 0.1 * rng.standard_normal(n)
    spec = jsgpr.SGPRSpec(kinds=("matern12",), features=(JCell.from_lims(20, 0.0, 1.0),),
                          jitter=1e-12)
    params = {"axes": ({"variance": np.asarray(1.0), "lengthscale": np.asarray(0.25)},),
              "noise": np.asarray(0.05)}
    return spec, x, y, params, (20,), (8,)


def _patch_jax_draws(mp, key, om, ph, eps):
    """Patch the JAX package's prior paths and ε draws to the table's rows,
    by the key each sample holds (the sampler splits ``key`` into one key a
    sample, each into (paths, ε)), as tests/test_torch_pathwise.py does."""
    keys = jax.random.split(key, om.shape[0])
    k1 = jnp.stack([jax.random.split(k)[0] for k in keys])
    k2 = jnp.stack([jax.random.split(k)[1] for k in keys])
    F = om.shape[-1]
    real_normal = jax.random.normal

    def paths(k, spec, params, n_features):
        j = jnp.argmax(jnp.all(k == k1, axis=-1))
        v = 1.0
        for ax in params["axes"]:
            v = v * ax["variance"]
        return jnp.asarray(om)[j], jnp.asarray(ph)[j], jnp.sqrt(2.0 * v / F)

    def normal(k, shape=(), dtype=float):
        if tuple(shape) != eps.shape[1:]:
            return real_normal(k, shape, dtype)
        return jnp.asarray(eps)[jnp.argmax(jnp.all(k == k2, axis=-1))].astype(dtype)

    mp.setattr(jsampling, "prior_paths", paths)
    mp.setattr(jax.random, "normal", normal)


def pathwise_case():
    spec, x, y, params, cells, grids = _pathwise_model()
    rng = np.random.default_rng(13)
    om = rng.standard_t(2.0, size=(PATH_SAMPLES, 1, PATH_FEATURES)) * 4.0
    ph = rng.random((PATH_SAMPLES, PATH_FEATURES)) * 2 * np.pi
    eps = rng.standard_normal((PATH_SAMPLES, x.shape[0]))
    inp = {**_sgpr_inputs(cells, grids, x, y, params), "om": om, "ph": ph, "eps": eps,
           "n_samples": np.asarray(PATH_SAMPLES)}

    def reference():
        g = (JCell.from_lims(grids[0], 0.0, 1.0),)
        p = jax.tree.map(jnp.asarray, params)
        kw = dict(n_samples=PATH_SAMPLES, n_features=PATH_FEATURES, tol=1e-10)
        out = {}
        for tag, key, head in (
                ("qv", jax.random.PRNGKey(7),
                 lambda p, X, y, key: jiter.q_v_pathwise(spec, p, X, y, g, key, **kw)),
                ("qdv", jax.random.PRNGKey(9),
                 lambda p, X, y, key: jiter.q_dv_pathwise(spec, p, X, y, g, 0, key, **kw))):
            with pytest.MonkeyPatch.context() as mp:
                _patch_jax_draws(mp, key, om, ph, eps)
                got = jax.jit(head)(p, jnp.asarray(x), jnp.asarray(y), key)
            out[tag] = {"mean": np.asarray(got.mean), "var": np.asarray(got.var)}
        return out

    return inp, reference


def global_draws_case():
    _, x, y, params, cells, grids = _pathwise_model()
    return {**_sgpr_inputs(cells, grids, x, y, params), "n_samples": np.asarray(PATH_SAMPLES),
            "n_features": np.asarray(256), "seed": np.asarray(3)}, None


# The meshes: (axis names, axis sizes, [(case, worker kind, its (inputs, reference))])
MESHES = {
    "data": (("data",), (2,), [
        ("assimilate", "assimilate", assimilate_case),
        ("cg kms-woodbury", "cg", lambda: cg_case(96)),
        ("cg jacobi", "cg", lambda: cg_case(8200, lengthscale=0.05, noise=1.0)),
        ("pathwise", "pathwise", pathwise_case),
        ("global draws", "global draws", global_draws_case),
        ("errors", "errors", lambda: ({}, None)),
        ("skip", "skip", skip_case)]),
    "data model": (("data", "model"), (2, 2), [
        ("step", "step", lambda: step_case((6, 4), grids=(5, 4))),
        ("fallback", "step", lambda: step_case((6, 5)))]),
    "data model1 model2": (("data", "model1", "model2"), (1, 2, 2), [
        ("step", "step", lambda: step_case((6, 4), ("model1", "model2"), grids=(5, 4))),
        ("3d", "step", lambda: step_case((4, 4, 3), ("model1", "model2", None)))]),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start every mesh's workers, compute the JAX references while they
    run, and read their outputs: {mesh: (references by case, outputs by
    rank)}."""
    root = tmp_path_factory.mktemp("parallel")
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1",
           "GLOO_SOCKET_IFNAME": "lo"}
    env.pop("PYTHONSTARTUP", None)
    started, refs = {}, {}
    for name, (axis_names, sizes, cases) in MESHES.items():
        built = {case: make() for case, _, make in cases}
        inputs = {f"{case}/{k}": v for case, (inp, _) in built.items() for k, v in inp.items()}
        np.savez(root / f"{name}_in.npz", **inputs)
        (root / f"{name}_meta.json").write_text(json.dumps(
            {"axis_names": axis_names, "axis_sizes": sizes,
             "cases": [(case, kind) for case, kind, _ in cases]}))
        world = math.prod(sizes)
        started[name] = [
            subprocess.Popen([sys.executable, str(WORKERS), str(root), name, str(r), str(world)],
                             cwd=REPO, env=env, stdout=open(root / f"{name}_{r}.log", "w"),
                             stderr=subprocess.STDOUT)
            for r in range(world)]
        refs[name] = built
    for name, built in refs.items():
        refs[name] = {case: ref() for case, (_, ref) in built.items() if ref is not None}
    out = {}
    for name, procs in started.items():
        codes = [p.wait(timeout=600) for p in procs]
        logs = "".join((root / f"{name}_{r}.log").read_text() for r in range(len(procs)))
        assert codes == [0] * len(procs), f"mesh {name}: exit codes {codes}\n{logs[-4000:]}"
        out[name] = (refs[name], [dict(np.load(root / f"{name}_out{r}.npz"))
                                  for r in range(len(procs))])
    return out


def _case(runs, mesh, case):
    """(the JAX reference, each rank's outputs of ``case``)."""
    refs, ranks = runs[mesh]
    head = case + "/"
    outs = [{k[len(head):]: v for k, v in r.items() if k.startswith(head)} for r in ranks]
    for r, o in enumerate(outs):
        assert "error" not in o, f"mesh {mesh}, case {case}, rank {r}:\n{o['error']}"
    return refs.get(case), outs, [r["coords"] for r in ranks]


def _block(full, axes, coords, mesh):
    """The block of ``full`` at ``coords`` under per-dimension mesh axes."""
    names, sizes = MESHES[mesh][:2]
    for dim, a in enumerate(axes):
        if a is not None:
            i = names.index(a)
            size = full.shape[dim] // sizes[i]
            full = np.take(full, np.arange(coords[i] * size, (coords[i] + 1) * size), axis=dim)
    return full


# the placement of each raw leaf that make_sharded_svgp_step must use
PLACEMENTS = {
    ("data model", "step"): {"q/mu": (None, "model"), "q/raw_L2": ("model", None)},
    ("data model", "fallback"): {},      # 5 cells do not split over 2: replicated
    ("data model1 model2", "step"): {"q/mu": ("model1", "model2"),
                                     "q/raw_L1": ("model1", None),
                                     "q/raw_L2": ("model2", None)},
    ("data model1 model2", "3d"): {"q/mu": ("model1", "model2", None),
                                   "q/raw_L1": ("model1", None),
                                   "q/raw_L2": ("model2", None)},
}


def test_workers_import_neither_jax_nor_the_jax_package(runs):
    for mesh, (_, ranks) in runs.items():
        for r, out in enumerate(ranks):
            assert out["jax modules"].size == 0, (mesh, r, out["jax modules"])


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("mesh, case", sorted(PLACEMENTS), ids=lambda v: str(v))
def test_sharded_step_matches_jax(runs, mesh, case, steps):
    """The loss to rtol 1e-12 and every raw leaf to rtol 1e-8, atol 1e-10
    after 1 and 3 steps against train.make_step_fn with optax.adam(0.05);
    each rank holds the block its placement names."""
    ref, outs, coords = _case(runs, mesh, case)
    for out, c in zip(outs, coords):
        np.testing.assert_allclose(out[f"loss{steps}"], ref[f"loss{steps}"], rtol=TOL_LOSS)
        want = ref[f"raw{steps}"]
        got = {k[len(f"raw{steps}/"):]: v for k, v in out.items()
               if k.startswith(f"raw{steps}/")}
        assert sorted(got) == sorted(want)
        for key, full in want.items():
            axes = PLACEMENTS[mesh, case].get(key, ())
            np.testing.assert_allclose(got[key], _block(full, axes, c, mesh), **TOL_LEAF,
                                       err_msg=f"{key} at {c}")


def test_sharded_step_skips_on_every_rank_together(runs):
    """A NaN in one process's rows: the loss all-reduces to NaN, and every
    process skips the step and keeps its init raw exactly (the JAX package's
    init raw within 1e-12), the one whose own rows are finite too (a local
    finite check would have stepped it)."""
    raw0, outs, _ = _case(runs, "data", "skip")
    assert [bool(o["own rows finite"]) for o in outs] == [True, False]
    for out in outs:
        assert np.isnan(out["loss"])
        for key, want in raw0.items():
            np.testing.assert_array_equal(out[f"raw/{key}"], out[f"raw0/{key}"], err_msg=key)
            np.testing.assert_allclose(out[f"raw0/{key}"], want, rtol=1e-12, atol=1e-15)


def test_sharded_losses_agree_on_every_rank(runs):
    for mesh, case in PLACEMENTS:
        _, outs, _ = _case(runs, mesh, case)
        for k in (1, 2, 3):
            assert len({float(o[f"loss{k}"]) for o in outs}) == 1, (mesh, case, k)


def test_sharded_qv_matches_jax(runs):
    """make_sharded_qv over the model-sharded state after 3 steps against
    the JAX package's q_v after its 3 unsharded steps: 1e-10, the same on
    every rank, on both meshes that shard the model."""
    for mesh in ("data model", "data model1 model2"):
        ref, outs, _ = _case(runs, mesh, "step")
        for out in outs:
            for k in ("mean", "var"):
                np.testing.assert_allclose(out[f"qv/{k}"], ref["qv"][k], **TOL_QV)
                np.testing.assert_array_equal(out[f"qv/{k}"], outs[0][f"qv/{k}"])
        assert np.all(outs[0]["qv/var"] > 0)


@pytest.mark.parametrize("variant", ["plain", "hetero"])
def test_sharded_assimilate_matches_jax(runs, variant):
    """Λ and η to 1e-10 against the unsharded assimilate, the point count
    exact: the increments are reduced, not the state."""
    ref, outs, _ = _case(runs, "data", "assimilate")
    for out in outs:
        for k in ("lam", "eta"):
            np.testing.assert_allclose(out[f"{variant}/{k}"], ref[variant][k], **TOL_STATE)
        assert float(out[f"{variant}/n_seen"]) == float(ref[variant]["n_seen"]) == 64.0


@pytest.mark.parametrize("case, preconditioner", [("cg kms-woodbury", "kms-woodbury"),
                                                  ("cg jacobi", "jacobi")])
def test_sharded_cg_matches_jax(runs, case, preconditioner):
    """solve_w and the q_v and q_dv mean heads to rtol 1e-6, atol 1e-8 on
    both preconditioner branches, and relative_residual under the shard. At n = 8200 each process holds 4100 ≤
    CG_KMS_MAX_POINTS points: the gate must read the global n and take
    Jacobi, as the unsharded solve does."""
    ref, outs, _ = _case(runs, "data", case)
    for out in outs:
        assert str(out["preconditioner"]) == str(out["preconditioner unsharded"]) \
            == preconditioner
        for k in ("w", "qv", "qdv"):
            np.testing.assert_allclose(out[k], ref[k], **TOL_CG, err_msg=k)
        np.testing.assert_allclose(out["w"], out["w unsharded"], **TOL_CG)
        np.testing.assert_array_equal(out["w"], outs[0]["w"])
        np.testing.assert_allclose(out["resid"], out["resid unsharded"], rtol=1e-10)
        # the partial sums round apart from the unsharded sums, and cond(G)
        # amplifies that through the iterates: the stopping test may fire a
        # few iterations apart
        its, its0 = int(out["iterations"]), int(out["iterations unsharded"])
        assert abs(its - its0) <= 0.05 * its0, (its, its0)


@pytest.mark.parametrize("head", ["qv", "qdv"])
def test_sharded_pathwise_matches_jax(runs, head):
    """The pathwise q(v) and q(dv) heads at S = 16 with both packages' draws
    patched to one table: 1e-6 against JAX's unsharded heads."""
    ref, outs, _ = _case(runs, "data", "pathwise")
    for out in outs:
        for k in ("mean", "var"):
            np.testing.assert_allclose(out[f"{head}/{k}"], ref[head][k], **TOL_PATHWISE)


@pytest.mark.parametrize("head", ["qv", "qdv"])
def test_sharded_draws_are_the_unsharded_draws(runs, head):
    """From one generator seed and no patch, the sharded heads equal the
    port's unsharded heads: each process drew every point's ε in step with
    the unsharded run."""
    _, outs, _ = _case(runs, "data", "global draws")
    for out in outs:
        for k in ("mean", "var"):
            np.testing.assert_allclose(out[f"{head}/{k}"], out[f"{head}/{k} unsharded"],
                                       **TOL_PATHWISE)


@pytest.mark.parametrize("what, error", [
    ("indivisible n", "ValueError: 63 points do not split over the 2 processes"),
    ("wrong world size", "ValueError: mesh wants 3 devices, have 2"),
    ("model_parallel", "ValueError: 2 devices not divisible by model_parallel=3"),
    ("cuda", "RuntimeError: a cuda mesh needs a CUDA device")])
def test_errors(runs, what, error):
    _, outs, _ = _case(runs, "data", "errors")
    for out in outs:
        assert str(out[what]).startswith(error), str(out[what])
