"""The processes of tests/test_torch_parallel.py: one a rank of a gloo world
on the CPU, running the port's ``parallel`` functions on numpy inputs.

Torch, numpy and the port only: a worker must not import JAX, and reports
whether anything did. pytest does not collect this file.

    python tests/_torch_parallel_workers.py DIR NAME RANK WORLD

reads DIR/NAME_meta.json (the mesh and the cases) and DIR/NAME_in.npz (the
inputs, keyed "case/..."), meets the other ranks at the FileStore
DIR/NAME_store and writes DIR/NAME_out{RANK}.npz: each case's outputs keyed
"case/...", or "case/error" with the traceback.
"""

from __future__ import annotations

import json
import math
import sys
import traceback
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

F64 = torch.float64


# --------------------------------------------------------------------------- #
# trees <-> flat "a/0/b" keys
# --------------------------------------------------------------------------- #

def flatten(tree, prefix: str = "") -> dict:
    """{"a/0/b": leaf} of a nested dict/tuple tree."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def unflatten(flat: dict):
    """The nested tree of :func:`flatten` (all-digit keys become tuples)."""
    root: dict = {}
    for key, v in flat.items():
        node = root
        *path, last = key.split("/")
        for k in path:
            node = node.setdefault(k, {})
        node[last] = v

    def build(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return tuple(build(node[str(i)]) for i in range(len(node)))
        return {k: build(v) for k, v in node.items()}

    return build(root)


def _sub(inp: dict, case: str) -> dict:
    head = case + "/"
    return {k[len(head):]: v for k, v in inp.items() if k.startswith(head)}


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=F64)


def _params(inp: dict, key: str):
    return unflatten({k[len(key) + 1:]: _t(v) for k, v in inp.items()
                      if k.startswith(key + "/")})


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy().copy() if isinstance(t, torch.Tensor) else np.asarray(t)


# --------------------------------------------------------------------------- #
# the cases
# --------------------------------------------------------------------------- #

def _kron_spec(cells, n):
    from vggp_tpu_torch.features import CellIntegralFeature
    from vggp_tpu_torch.models import svgp

    return svgp.SVGPSpec(kinds=("matern12",) * len(cells),
                         features=tuple(CellIntegralFeature.from_lims(m, 0.0, 1.0)
                                        for m in cells),
                         num_data=n, variational="kron")


def case_step(mesh, inp):
    """make_sharded_svgp_step with Adam(0.05): 3 steps from the init params
    on this rank's rows; the losses, and this rank's raw blocks after steps
    1 and 3."""
    from vggp_tpu_torch.parallel import make_sharded_svgp_step, shard_batch

    cells = tuple(int(m) for m in inp["cells"])
    X, y = _t(inp["X"]), _t(inp["y"])
    spec = _kron_spec(cells, y.shape[0])
    axes = [None if a == "" else str(a) for a in inp["model_axes"]] \
        if "model_axes" in inp else None
    init_fn, step_fn = make_sharded_svgp_step(
        spec, lambda ps: torch.optim.Adam(ps, lr=0.05), mesh, model_axes=axes)
    raw, opt = init_fn(_params(inp, "params"))
    xb, yb = shard_batch(X, y, mesh)
    out = {}
    for k in range(1, 4):
        raw, opt, loss = step_fn(raw, opt, xb, yb)
        out[f"loss{k}"] = _np(loss)
        if k in (1, 3):
            out.update({f"raw{k}/{key}": _np(v) for key, v in flatten(raw).items()})
    if "grids" in inp:
        from vggp_tpu_torch.features import CellIntegralFeature
        from vggp_tpu_torch.parallel import make_sharded_qv

        grids = tuple(CellIntegralFeature.from_lims(int(g), 0.0, 1.0) for g in inp["grids"])
        q = make_sharded_qv(spec, mesh, grids, model_axes=axes)(raw)
        out["qv/mean"], out["qv/var"] = _np(q.mean), _np(q.var)
    return out


def case_skip(mesh, inp):
    """One step of make_sharded_svgp_step where one rank's rows hold a NaN:
    the reduced loss is NaN on every rank, so every rank skips the step,
    the ranks whose own rows are finite too."""
    from vggp_tpu_torch.parallel import make_sharded_svgp_step, shard_batch

    X, y = _t(inp["X"]), _t(inp["y"])
    spec = _kron_spec(tuple(int(m) for m in inp["cells"]), y.shape[0])
    init_fn, step_fn = make_sharded_svgp_step(
        spec, lambda ps: torch.optim.Adam(ps, lr=0.05), mesh)
    raw, opt = init_fn(_params(inp, "params"))
    before = {f"raw0/{key}": _np(v) for key, v in flatten(raw).items()}
    xb, yb = shard_batch(X, y, mesh)
    raw, opt, loss = step_fn(raw, opt, xb, yb)
    return {"loss": _np(loss), "own rows finite": np.asarray(bool(torch.isfinite(yb).all())),
            **before, **{f"raw/{key}": _np(v) for key, v in flatten(raw).items()}}


def case_assimilate(mesh, inp):
    """make_sharded_assimilate, plain and heteroscedastic, from the prior
    state on this rank's rows."""
    from vggp_tpu_torch import streaming
    from vggp_tpu_torch.features import CellIntegralFeature
    from vggp_tpu_torch.models import svgp
    from vggp_tpu_torch.parallel import make_sharded_assimilate, shard_batch

    X, y, noise = _t(inp["X"]), _t(inp["y"]), _t(inp["noise"])
    spec = svgp.SVGPSpec(kinds=("matern12", "matern12"),
                         features=(CellIntegralFeature.from_lims(6, 0.0, 1.0),
                                   CellIntegralFeature.from_lims(4, 0.0, 1.0)),
                         num_data=y.shape[0], variational="full")
    params = _params(inp, "params")
    xb, yb = shard_batch(X, y, mesh)
    _, nb = shard_batch(X, noise, mesh)
    out = {}
    for tag, fn, args in (("plain", make_sharded_assimilate(spec, params, mesh), ()),
                          ("hetero", make_sharded_assimilate(spec, params, mesh,
                                                             heteroscedastic=True), (nb,))):
        s = fn(streaming.init_state(spec, F64, "cpu"), xb, yb, *args)
        out.update({f"{tag}/{k}": _np(v) for k, v in s.items()})
    return out


def _sgpr(inp):
    from vggp_tpu_torch.features import CellIntegralFeature
    from vggp_tpu_torch.models import sgpr

    cells = tuple(int(m) for m in inp["cells"])
    spec = sgpr.SGPRSpec(kinds=("matern12",) * len(cells),
                         features=tuple(CellIntegralFeature.from_lims(m, 0.0, 1.0)
                                        for m in cells), jitter=1e-12)
    grids = tuple(CellIntegralFeature.from_lims(int(g), 0.0, 1.0) for g in inp["grids"])
    return spec, _params(inp, "params"), _t(inp["X"]), _t(inp["y"]), grids


def case_cg(mesh, inp):
    """make_sharded_solve_w (with its info), make_sharded_qv_mean_cg and
    make_sharded_qdv_mean_cg on axis 0 at tol 1e-12, maxiter 4000, beside
    the port's unsharded solve_w on all the points; relative_residual of a
    5-iteration w on this rank's rows under a DataShard and on all the
    points."""
    from vggp_tpu_torch.models import iterative
    from vggp_tpu_torch.parallel import (make_sharded_qdv_mean_cg, make_sharded_qv_mean_cg,
                                         make_sharded_solve_w, shard_batch)
    from vggp_tpu_torch.parallel.cg import _data_shard

    spec, p, X, y, grids = _sgpr(inp)
    xb, yb = shard_batch(X, y, mesh)
    kw = dict(tol=1e-12, maxiter=4000)
    w, info = make_sharded_solve_w(spec, mesh, **kw)(p, xb, yb, return_info=True)
    w0, info0 = iterative.solve_w(spec, p, X, y, return_info=True, **kw)
    shard = _data_shard(mesh, "data", yb.shape[0])
    rough = iterative.solve_w(spec, p, X, y, maxiter=5)
    return {"w": _np(w), "iterations": np.asarray(info["iterations"]),
            "resid": _np(iterative.relative_residual(spec, p, xb, yb, rough, shard=shard)),
            "resid unsharded": _np(iterative.relative_residual(spec, p, X, y, rough)),
            "preconditioner": np.asarray(info["preconditioner"]),
            "w unsharded": _np(w0), "iterations unsharded": np.asarray(info0["iterations"]),
            "preconditioner unsharded": np.asarray(info0["preconditioner"]),
            "qv": _np(make_sharded_qv_mean_cg(spec, mesh, grids, **kw)(p, xb, yb)),
            "qdv": _np(make_sharded_qdv_mean_cg(spec, mesh, grids, 0, **kw)(p, xb, yb))}


def _patch_draws(om, ph, eps):
    """The port's prior paths and ε draws from the numpy table, row by row
    in call order (the parent patches the JAX package's to the same rows)."""
    from vggp_tpu_torch import sampling

    rows, eps_rows = iter(range(om.shape[0])), iter(range(om.shape[0]))
    F = om.shape[-1]

    def paths(gen, spec, params, n_features):
        v = 1.0
        for ax in params["axes"]:
            v = v * ax["variance"]
        j = next(rows)
        return _t(om[j]), _t(ph[j]), torch.sqrt(2.0 * v / F)

    sampling.prior_paths = paths
    sampling.normal = lambda gen, shape, like: _t(eps[next(eps_rows)])


def case_pathwise(mesh, inp):
    """make_sharded_pathwise_qv and _qdv (axis 0) at S = 16, F = 512,
    tol 1e-10, their draws patched to the parent's table."""
    from vggp_tpu_torch import sampling
    from vggp_tpu_torch.parallel import (make_sharded_pathwise_qdv, make_sharded_pathwise_qv,
                                         shard_batch)

    spec, p, X, y, grids = _sgpr(inp)
    xb, yb = shard_batch(X, y, mesh)
    S = int(inp["n_samples"])
    kw = dict(n_samples=S, n_features=int(inp["om"].shape[-1]), tol=1e-10)
    real = sampling.prior_paths, sampling.normal
    out = {}
    try:
        for tag, fn in (("qv", make_sharded_pathwise_qv(spec, mesh, grids, **kw)),
                        ("qdv", make_sharded_pathwise_qdv(spec, mesh, grids, 0, **kw))):
            _patch_draws(inp["om"], inp["ph"], inp["eps"])
            g = fn(p, xb, yb, torch.Generator())
            out[f"{tag}/mean"], out[f"{tag}/var"] = _np(g.mean), _np(g.var)
    finally:
        sampling.prior_paths, sampling.normal = real
    return out


def case_global_draws(mesh, inp):
    """The sharded pathwise heads against the port's unsharded ones on all
    the points, from one torch.Generator seed and no patch: equal only if
    every rank drew every point's ε, in the unsharded order."""
    from vggp_tpu_torch.models import iterative
    from vggp_tpu_torch.parallel import (make_sharded_pathwise_qdv, make_sharded_pathwise_qv,
                                         shard_batch)

    spec, p, X, y, grids = _sgpr(inp)
    xb, yb = shard_batch(X, y, mesh)
    kw = dict(n_samples=int(inp["n_samples"]), n_features=int(inp["n_features"]), tol=1e-10)
    gen = lambda: torch.Generator().manual_seed(int(inp["seed"]))
    out = {}
    for tag, sharded, plain in (
            ("qv", make_sharded_pathwise_qv(spec, mesh, grids, **kw),
             lambda: iterative.q_v_pathwise(spec, p, X, y, grids, gen(), **kw)),
            ("qdv", make_sharded_pathwise_qdv(spec, mesh, grids, 0, **kw),
             lambda: iterative.q_dv_pathwise(spec, p, X, y, grids, 0, gen(), **kw))):
        g, g0 = sharded(p, xb, yb, gen()), plain()
        out.update({f"{tag}/mean": _np(g.mean), f"{tag}/var": _np(g.var),
                    f"{tag}/mean unsharded": _np(g0.mean), f"{tag}/var unsharded": _np(g0.var)})
    return out


def case_errors(mesh, inp):
    """The ValueErrors of an indivisible n and of a wrong world size, and
    the refusal of a cuda mesh without a card; their messages."""
    from vggp_tpu_torch.parallel import data_model_mesh, make_mesh, shard_batch

    out = {}
    for tag, fn in (("indivisible n", lambda: shard_batch(torch.zeros(63, 2), torch.zeros(63),
                                                          mesh)),
                    ("wrong world size", lambda: make_mesh(("data",), (3,), device_type="cpu")),
                    ("model_parallel", lambda: data_model_mesh(model_parallel=3,
                                                               device_type="cpu")),
                    ("cuda", lambda: make_mesh(("data",), (2,), device_type="cuda"))):
        try:
            fn()
            out[tag] = np.asarray("no error")
        except Exception as e:  # noqa: BLE001 - the error is the output
            out[tag] = np.asarray(f"{type(e).__name__}: {e}")
    return out


CASES = {"step": case_step, "skip": case_skip, "assimilate": case_assimilate, "cg": case_cg,
         "pathwise": case_pathwise, "global draws": case_global_draws, "errors": case_errors}


def main(argv) -> int:
    root, name, rank, world = Path(argv[1]), argv[2], int(argv[3]), int(argv[4])
    torch.set_num_threads(1)
    meta = json.loads((root / f"{name}_meta.json").read_text())
    inp = dict(np.load(root / f"{name}_in.npz"))
    dist.init_process_group("gloo", store=dist.FileStore(str(root / f"{name}_store"), world),
                            rank=rank, world_size=world, timeout=timedelta(seconds=120))
    from vggp_tpu_torch.parallel import make_mesh

    assert math.prod(meta["axis_sizes"]) == world
    mesh = make_mesh(meta["axis_names"], meta["axis_sizes"], device_type="cpu")
    out = {"coords": np.asarray([mesh.get_local_rank(a) for a in meta["axis_names"]])}
    for case, kind in meta["cases"]:
        try:
            res = CASES[kind](mesh, _sub(inp, case))
            out.update({f"{case}/{k}": v for k, v in res.items()})
        except Exception:  # noqa: BLE001 - reported to the parent
            out[f"{case}/error"] = np.asarray(traceback.format_exc())
    dist.destroy_process_group()
    out["jax modules"] = np.asarray(sorted(k for k in sys.modules if k.split(".")[0]
                                           in ("jax", "jaxlib", "optax", "vggp_tpu")), dtype=str)
    np.savez(root / f"{name}_out{rank}.npz", **out)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
