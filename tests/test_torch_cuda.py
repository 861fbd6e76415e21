"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs a CUDA device and skips without one. This file imports
neither JAX nor the JAX package, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from chip_smoke import gauss_err, heads_tol, stretched_mesh
from vggp_tpu_torch import CellIntegralFeature, SVGPSpec, convert, svgp, train
from vggp_tpu_torch.ops import cell_kuf as ck
from vggp_tpu_torch.ops import kms


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("precisions", [("highest", "highest"), ("highest", "default")])
@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-12), (torch.float32, 2e-5)])
@pytest.mark.parametrize("m,n", [(256, 301), (512, 1024)])
def test_cuda_kernels_match_plain(cuda, dtype, rtol, m, n, precisions):
    """max|Δ|/max|plain| per output: roundoff in f64 (where the precision
    strings are ignored); in f32 2e-5, except the fused ℓ-tangent t. At
    "highest" t is held at 1e-3 (summation order under cancellation); at
    "default" it is one TF32 product, whose error against the f64 plain
    version may be at most 2× that of torch's own TF32 product (the plain
    version at "default")."""
    mesh = torch.linspace(0.0, 1.0, m + 1, dtype=dtype, device=cuda)
    x = torch.linspace(-0.1, 1.1, n, dtype=dtype, device=cuda)
    v = torch.tensor(1.3, dtype=dtype, device=cuda)
    ell = torch.tensor(0.27, dtype=dtype, device=cuda)
    finv = kms.m12_cell_inv_chol(m, 1.0 / m, v, ell, 1e-6)
    before = dict(ck.LAUNCHES)
    pairs = [(ck.cell_kuf(mesh, x, v, ell), ck.cell_kuf_plain(mesh, x, v, ell), rtol)]
    pairs += [(g, w, rtol) for g, w in zip(ck.cell_kuf_with_dl(mesh, x, v, ell),
                                           ck.cell_kuf_with_dl_plain(mesh, x, v, ell))]
    a, t = ck.fused_banded_whiten_kuf(finv, mesh, x, v, ell, *precisions)
    a_p, t_p = ck.fused_banded_whiten_kuf_plain(finv, mesh, x, v, ell, *precisions)
    pairs.append((a, a_p, rtol))
    tf32_t = dtype == torch.float32 and precisions[1] == "default"
    if not tf32_t:
        pairs.append((t, t_p, rtol if dtype == torch.float64 else 1e-3))
    torch.cuda.synchronize()
    assert all(ck.LAUNCHES[k] == before[k] + 1 for k in ck.LAUNCHES)
    for got, want, tol in pairs:
        assert got.shape == want.shape
        err = float((got - want).abs().max() / want.abs().max())
        assert err < tol, err
    if tf32_t:
        _, t64 = ck.fused_banded_whiten_kuf_plain(
            *(z.double() for z in (finv, mesh, x, v, ell)), "highest", "highest")
        rel = lambda z: float((z.double() - t64).abs().max() / t64.abs().max())
        assert rel(t) <= 2.0 * rel(t_p), (rel(t), rel(t_p))


@pytest.mark.cuda
@pytest.mark.parametrize("m,n", [(10, 37), (63, 127)])
def test_cuda_small_shapes_launch_the_kernels(cuda, m, n):
    """Below the JAX package's Pallas minimums (64 cells, 128 points) the
    feature still goes through the kernels on the card; f64, 1e-12."""
    g = CellIntegralFeature.from_lims(m, 0.0, 1.0)
    p = {"variance": torch.tensor(1.3, dtype=torch.float64, device=cuda),
         "lengthscale": torch.tensor(0.27, dtype=torch.float64, device=cuda)}
    x = torch.linspace(-0.2, 1.2, n, dtype=torch.float64, device=cuda)
    mesh = g.mesh_j(p)
    ck.reset_launch_counts()
    kuf = g.Kuf("matern12", p, x)
    kuf_dl = g.Kuf_with_dl("matern12", p, x)
    assert ck.LAUNCHES == {"cell_kuf": 1, "cell_kuf_with_dl": 1, "fused_banded_whiten_kuf": 0}
    pairs = [(kuf, ck.cell_kuf_plain(mesh, x, p["variance"], p["lengthscale"]))]
    pairs += zip(kuf_dl, ck.cell_kuf_with_dl_plain(mesh, x, p["variance"], p["lengthscale"]))
    for got, want in pairs:
        assert float((got - want).abs().max() / want.abs().max()) < 1e-12


def _at_offset(t):
    """t's values in a contiguous view one element into a larger buffer: a
    4-byte (f32) or 8-byte (f64) offset, so not 16-byte aligned."""
    big = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    big[1:] = t
    return big[1:]


_EDGES = torch.linspace(0.0, 1.0, 17, dtype=torch.float64)
_MESH = torch.linspace(0.0, 1.0, 65, dtype=torch.float64)


def _points(n):
    return torch.linspace(-0.1, 1.1, n, dtype=torch.float64)


_LAYOUTS = {
    # (mesh, x): ragged rows (n % 4 = 1, 2, 3), fewer points than one warp's
    # 16-byte chunk, one cell, x at an offset, points on every edge and far
    # outside (f32 exp underflows to 0 there)
    "n%4=1": (_MESH, _points(1025)),
    "n%4=2": (_MESH, _points(1026)),
    "n%4=3": (_MESH, _points(1027)),
    "n<chunk": (torch.linspace(0.0, 1.0, 6, dtype=torch.float64), _points(100)),
    "m=1": (torch.tensor([0.25, 0.5], dtype=torch.float64), _points(4096)),
    "x_offset": (_MESH, _points(1024)),
    "edges": (_EDGES, torch.cat([_EDGES, (_EDGES[:-1] + _EDGES[1:]) / 2,
                                 torch.tensor([-60.0, 1.5, 80.0], dtype=torch.float64)])),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-12), (torch.float32, 2e-5)])
@pytest.mark.parametrize("case", sorted(_LAYOUTS))
def test_cuda_cell_kuf_layouts_match_plain(cuda, dtype, rtol, case):
    """cell_kuf against its plain version where the kernel leaves its
    16-byte path (ragged rows, x at an offset) or its grid is tiny:
    max|Δ|/max|plain| at 1e-12 (f64) and 2e-5 (f32), one launch each."""
    mesh, x = (z.to(dtype=dtype, device=cuda) for z in _LAYOUTS[case])
    if case == "x_offset":
        x = _at_offset(x)
        assert x.is_contiguous() and x.data_ptr() % 16 != 0
    v = torch.tensor(1.3, dtype=dtype, device=cuda)
    ell = torch.tensor(0.27, dtype=dtype, device=cuda)
    before = ck.LAUNCHES["cell_kuf"]
    got = ck.cell_kuf(mesh, x, v, ell)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["cell_kuf"] == before + 1
    want = ck.cell_kuf_plain(mesh, x, v, ell)
    assert got.shape == want.shape == (mesh.numel() - 1, x.numel())
    assert float((got - want).abs().max() / want.abs().max()) < rtol
    if case == "edges" and dtype == torch.float32:
        far = x.abs() > 40
        assert bool((got[:, far] == 0).all()) and bool((want[:, far] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-12), (torch.float32, 2e-5)])
def test_cuda_cell_kuf_at_face_edges_matches_plain(cuda, dtype, rtol):
    """q_dv's face difference on the model's own cells: cell_kuf at
    (512, 513) with x the mesh itself, every point on a cell edge (inside
    both adjacent cells) and n % 4 = 1 (the scalar instance); one launch."""
    mesh = torch.linspace(0.0, 1.0, 513, dtype=torch.float64).to(dtype=dtype, device=cuda)
    v = torch.tensor(1.3, dtype=dtype, device=cuda)
    ell = torch.tensor(0.9, dtype=dtype, device=cuda)
    before = ck.LAUNCHES["cell_kuf"]
    got = ck.cell_kuf(mesh, mesh, v, ell)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["cell_kuf"] == before + 1
    want = ck.cell_kuf_plain(mesh, mesh, v, ell)
    assert got.shape == want.shape == (512, 513)
    assert float((got - want).abs().max() / want.abs().max()) < rtol


@pytest.mark.cuda
@pytest.mark.parametrize("head", ["posterior", "q_v"])
def test_cuda_warm_heads_match_cold(cuda, head):
    """posterior_from_state and q_v_from_state on the card (float32) against
    their cold heads on the card, within chip_smoke.py's serving-heads bound
    (``heads_tol``) of the same gap in float32 on the CPU. The warm
    posterior whitens through dense Cholesky factors and launches cell_kuf
    once per axis; the cold one is taken with gradients on, so it whitens
    through the closed-form F⁻¹ and launches cell_kuf_with_dl instead."""
    rng = np.random.default_rng(3)
    m = 128
    spec = SVGPSpec(kinds=("matern12",) * 2,
                    features=tuple(CellIntegralFeature.from_lims(m, 0.0, 1.0) for _ in range(2)),
                    num_data=100_000, variational="kron")
    p_np = {"axes": ({"variance": np.asarray(1.3), "lengthscale": np.asarray(0.2)},
                     {"variance": np.asarray(0.8), "lengthscale": np.asarray(0.3)}),
            "noise": np.asarray(0.05),
            "q": {"mu": 0.3 * rng.standard_normal((m, m)),
                  "raw_L1": np.eye(m) * 0.5413 + 0.01 * np.tril(rng.standard_normal((m, m))),
                  "raw_L2": np.eye(m) * 0.5413 + 0.01 * np.tril(rng.standard_normal((m, m)))}}
    x = rng.random((1000, 2))
    gaps = {}
    for dev in (cuda, "cpu"):
        p = convert.params_from_jax(p_np, dev, torch.float32)
        xs = torch.tensor(x, dtype=torch.float32, device=dev)
        with torch.no_grad():
            state = svgp.precompute(spec, p)
            ck.reset_launch_counts()
            if head == "posterior":
                warm = svgp.posterior_from_state(spec, p, state, xs)
                with torch.enable_grad():
                    cold = svgp.posterior(
                        spec, train.tree_map(lambda v: v.clone().requires_grad_(), p), xs)
            else:
                warm, cold = (svgp.q_v_from_state(spec, p, state, spec.features),
                              svgp.q_v(spec, p, spec.features))
        if dev == cuda:
            torch.cuda.synchronize()
            n = 2 if head == "posterior" else 0
            assert (ck.LAUNCHES["cell_kuf"], ck.LAUNCHES["cell_kuf_with_dl"]) == (n, n)
            assert bool(torch.isfinite(warm.mean).all() and (warm.var > 0).all())
        gaps[str(dev)] = gauss_err(warm, cold)
    assert gaps["cuda"] <= heads_tol(gaps["cpu"]), gaps


@pytest.mark.cuda
def test_cuda_wrappers_check_their_inputs(cuda):
    mesh = torch.linspace(0.0, 1.0, 129, device=cuda)
    x = torch.linspace(0.0, 1.0, 512, device=cuda)
    with pytest.raises(ValueError):
        ck.cell_kuf(mesh, x[::2], 1.0, 0.3)                 # not contiguous
    with pytest.raises(TypeError):
        ck.cell_kuf(mesh, x.double(), 1.0, 0.3)             # mixed dtypes
    with pytest.raises(ValueError):
        ck.fused_banded_whiten_kuf(torch.eye(100, device=cuda),
                                   torch.linspace(0.0, 1.0, 101, device=cuda),
                                   x, 1.0, 0.3, "highest", "default")   # m not a multiple of 128
    with pytest.raises(ValueError):
        ck.fused_banded_whiten_kuf(torch.eye(128, device=cuda), mesh, x, 1.0, 0.3,
                                   "highest", "fastest")     # unknown precision


@pytest.mark.cuda
def test_cuda_slice_matches_cpu_f64(cuda):
    """The loss on the card in f32 vs the same loss on the CPU in f64 (rtol
    1e-4, as the f32 CPU check), through the kernels (counted)."""
    rng = np.random.default_rng(0)
    m_axis, nb = 256, 512
    spec = SVGPSpec(kinds=("matern12",) * 2,
                    features=tuple(CellIntegralFeature.from_lims(m_axis, 0.0, 1.0)
                                   for _ in range(2)),
                    num_data=100_000, variational="kron")
    p_np = {"axes": ({"variance": np.asarray(1.3), "lengthscale": np.asarray(0.2)},
                     {"variance": np.asarray(0.8), "lengthscale": np.asarray(0.3)}),
            "noise": np.asarray(0.05),
            "q": {"mu": 0.3 * rng.standard_normal((m_axis, m_axis)),
                  "raw_L1": np.eye(m_axis) * 0.5413 + 0.01 * np.tril(rng.standard_normal((m_axis, m_axis))),
                  "raw_L2": np.eye(m_axis) * 0.5413 + 0.01 * np.tril(rng.standard_normal((m_axis, m_axis)))}}
    x = rng.random((nb, 2))
    y = np.sin(6 * x[:, 0]) * np.cos(5 * x[:, 1]) + 0.1 * rng.standard_normal(nb)
    with torch.no_grad():
        want = float(svgp.loss(spec, convert.params_from_jax(p_np, "cpu", torch.float64),
                               torch.tensor(x), torch.tensor(y)))
        ck.reset_launch_counts()
        got = float(svgp.loss(spec, convert.params_from_jax(p_np, cuda, torch.float32),
                               torch.tensor(x, dtype=torch.float32, device=cuda),
                               torch.tensor(y, dtype=torch.float32, device=cuda)))
    assert ck.LAUNCHES["cell_kuf"] == 2
    np.testing.assert_allclose(got, want, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-12), (torch.float32, 2e-5)])
@pytest.mark.parametrize("n", [65536, 4096, 65531])
def test_cuda_cell_kernels_on_64_cell_axes_match_plain(cuda, dtype, rtol, n):
    """Both cell kernels at the collapsed and exact models' 64-cell axes (a
    row tile below the 128 rows of the SVGP's shapes; n % 4 = 3 takes the
    scalar instance): max|Δ|/max|plain| at 1e-12 (f64) and 2e-5 (f32), one
    launch each."""
    mesh = torch.linspace(0.0, 1.0, 65, dtype=torch.float64).to(dtype=dtype, device=cuda)
    x = torch.linspace(-0.05, 1.05, n, dtype=torch.float64).to(dtype=dtype, device=cuda)
    v = torch.tensor(1.3, dtype=dtype, device=cuda)
    ell = torch.tensor(0.27, dtype=dtype, device=cuda)
    ck.reset_launch_counts()
    pairs = [(ck.cell_kuf(mesh, x, v, ell), ck.cell_kuf_plain(mesh, x, v, ell))]
    pairs += zip(ck.cell_kuf_with_dl(mesh, x, v, ell), ck.cell_kuf_with_dl_plain(mesh, x, v, ell))
    torch.cuda.synchronize()
    assert ck.LAUNCHES == {"cell_kuf": 1, "cell_kuf_with_dl": 1, "fused_banded_whiten_kuf": 0}
    for got, want in pairs:
        assert got.shape == want.shape == (64, n)
        assert float((got - want).abs().max() / want.abs().max()) < rtol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-12), (torch.float32, 2e-5)])
def test_cuda_cell_kuf_at_64_cell_face_edges_matches_plain(cuda, dtype, rtol):
    """The collapsed model's q_dv face difference: cell_kuf at (64, 65) with
    x the mesh itself; one launch."""
    mesh = torch.linspace(0.0, 1.0, 65, dtype=torch.float64).to(dtype=dtype, device=cuda)
    v = torch.tensor(1.3, dtype=dtype, device=cuda)
    ell = torch.tensor(0.2, dtype=dtype, device=cuda)
    before = ck.LAUNCHES["cell_kuf"]
    got = ck.cell_kuf(mesh, mesh, v, ell)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["cell_kuf"] == before + 1
    want = ck.cell_kuf_plain(mesh, mesh, v, ell)
    assert got.shape == want.shape == (64, 65)
    assert float((got - want).abs().max() / want.abs().max()) < rtol


_UNEVEN_MESHES = {
    # chip_smoke's 512-cell mesh refined toward the middle, and the 7-cell
    # mesh of tests/test_nonuniform.py (cell widths 0.06 to 0.29)
    "stretched": stretched_mesh(512),
    "uneven": np.array([0.0, 0.07, 0.21, 0.30, 0.55, 0.61, 0.90, 1.0]),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-12), (torch.float32, 2e-5)])
@pytest.mark.parametrize("points", ["scattered", "edges"])
@pytest.mark.parametrize("mesh_name", sorted(_UNEVEN_MESHES))
def test_cuda_cell_kernels_on_uneven_meshes_match_plain(cuda, dtype, rtol, points, mesh_name):
    """Both cell kernels on meshes whose cells differ in width: 4096 points
    scattered over the mesh and beyond it, or every point on a cell edge (a
    point on a shared edge lies inside both of its cells);
    max|Δ|/max|plain| at 1e-12 (f64) and 2e-5 (f32), one launch each."""
    mesh = torch.as_tensor(_UNEVEN_MESHES[mesh_name], dtype=dtype, device=cuda)
    x = (mesh.clone() if points == "edges" else
         torch.linspace(-0.05, 1.05, 4096, dtype=torch.float64).to(dtype=dtype, device=cuda))
    v = torch.tensor(1.3, dtype=dtype, device=cuda)
    ell = torch.tensor(0.27, dtype=dtype, device=cuda)
    ck.reset_launch_counts()
    pairs = [(ck.cell_kuf(mesh, x, v, ell), ck.cell_kuf_plain(mesh, x, v, ell))]
    pairs += zip(ck.cell_kuf_with_dl(mesh, x, v, ell), ck.cell_kuf_with_dl_plain(mesh, x, v, ell))
    torch.cuda.synchronize()
    assert ck.LAUNCHES == {"cell_kuf": 1, "cell_kuf_with_dl": 1, "fused_banded_whiten_kuf": 0}
    for got, want in pairs:
        assert got.shape == want.shape == (mesh.shape[0] - 1, x.shape[0])
        assert float((got - want).abs().max() / want.abs().max()) < rtol


@pytest.mark.cuda
def test_cuda_collapsed_bound_matches_cpu_f64(cuda):
    """The collapsed bound of a 64×64-cell GriddedGP at n = 16384 on the card
    (float32): cell_kuf_with_dl once per axis and never the fused kernel
    (64-cell axes fail its gate, though n reaches its minimum); the ELBO
    and every gradient leaf against the CPU's float64 by chip_smoke.py's
    rule (``check_quantities``). The gradient floor, 1e-3, is 6× the
    largest leaf error on an H100 (dσ², 1.7e-4); a TF32 ℓ-tangent misses
    it by 10× and more at half this n (tools/torch_grad_control.py)."""
    from chip_smoke import check_quantities, value_and_grads

    from vggp_tpu_torch import SGPRSpec, sgpr

    spec = SGPRSpec(kinds=("matern12",) * 2,
                    features=tuple(CellIntegralFeature.from_lims(64, 0.0, 1.0) for _ in range(2)))
    rng = np.random.default_rng(5)
    x = rng.random((16384, 2))
    y = np.sin(6 * x[:, 0]) * np.cos(5 * x[:, 1]) + 0.1 * rng.standard_normal(16384)
    p_np = {"axes": ({"variance": np.asarray(0.2), "lengthscale": np.asarray(0.3)},
                     {"variance": np.asarray(0.2), "lengthscale": np.asarray(0.25)}),
            "noise": np.asarray(0.02)}
    out = {}
    for tag, dev, dt in (("card", cuda, torch.float32), ("f64", "cpu", torch.float64),
                         ("f32", "cpu", torch.float32)):
        p = convert.params_from_jax(p_np, dev, dt)
        X, Y = (torch.tensor(a, dtype=dt, device=dev) for a in (x, y))
        ck.reset_launch_counts()
        val, grads = value_and_grads(lambda q: sgpr.loss(spec, q, X, Y), p)
        if tag == "card":
            torch.cuda.synchronize()
            assert ck.LAUNCHES == {"cell_kuf": 0, "cell_kuf_with_dl": 2,
                                   "fused_banded_whiten_kuf": 0}
        out[tag] = {"loss": val, **grads}
    check_quantities("collapsed bound", out["card"], out["f64"], out["f32"], 1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-12), (torch.float32, 2e-5)])
@pytest.mark.parametrize("m,n", [(15, 20000), (64, 4096), (512, 4096)])
def test_cuda_cell_kernels_at_the_full_family_and_zoo_shapes(cuda, dtype, rtol, m, n):
    """Both cell kernels at the shapes of the full family and the zoo: the
    2-D full family's (64, 4096), the 1-D full family's (512, 4096) on
    points over [0, 1], and the zoo's odd 15 cells at (15, 20 000); one
    launch each, 1e-12 (f64) and 2e-5 (f32) of the plain version."""
    rng = np.random.default_rng(m)
    mesh = torch.linspace(0.0, 1.0, m + 1, dtype=torch.float64).to(dtype=dtype, device=cuda)
    x = torch.as_tensor(rng.random(n), dtype=dtype, device=cuda)
    v = torch.tensor(1.3, dtype=dtype, device=cuda)
    ell = torch.tensor(0.27, dtype=dtype, device=cuda)
    ck.reset_launch_counts()
    pairs = [(ck.cell_kuf(mesh, x, v, ell), ck.cell_kuf_plain(mesh, x, v, ell))]
    pairs += zip(ck.cell_kuf_with_dl(mesh, x, v, ell), ck.cell_kuf_with_dl_plain(mesh, x, v, ell))
    torch.cuda.synchronize()
    assert ck.LAUNCHES == {"cell_kuf": 1, "cell_kuf_with_dl": 1, "fused_banded_whiten_kuf": 0}
    for got, want in pairs:
        assert got.shape == want.shape == (m, n)
        assert float((got - want).abs().max() / want.abs().max()) < rtol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cuda_fused_kernel_on_one_axis_matches_plain(cuda, dtype):
    """The fused kernel at the 1-D full family's (512, 16 384) on points
    over [0, 1], at the main path's precisions: a at 1e-12 (f64) and 2e-5
    (f32), t at 1e-12 and 1e-3; one launch."""
    rng = np.random.default_rng(3)
    mesh = torch.linspace(0.0, 1.0, 513, dtype=torch.float64).to(dtype=dtype, device=cuda)
    x = torch.as_tensor(rng.random(16384), dtype=dtype, device=cuda)
    v = torch.tensor(1.3, dtype=dtype, device=cuda)
    ell = torch.tensor(0.27, dtype=dtype, device=cuda)
    finv = kms.m12_cell_inv_chol(512, 1.0 / 512, v, ell, 1e-6)
    before = ck.LAUNCHES["fused_banded_whiten_kuf"]
    got = ck.fused_banded_whiten_kuf(finv, mesh, x, v, ell, "highest", "high")
    torch.cuda.synchronize()
    assert ck.LAUNCHES["fused_banded_whiten_kuf"] == before + 1
    want = ck.fused_banded_whiten_kuf_plain(finv, mesh, x, v, ell, "highest", "high")
    f64 = dtype == torch.float64
    for g, w, tol in zip(got, want, (1e-12 if f64 else 2e-5, 1e-12 if f64 else 1e-3)):
        assert float((g - w).abs().max() / w.abs().max()) < tol


@pytest.mark.cuda
@pytest.mark.parametrize("feature", ["cells", "points", "vff", "b3"])
def test_cuda_full_family_matches_cpu_f64(cuda, feature):
    """The 1-D full-family SVGP with a learned mean, its loss on the card in
    f32 against the CPU in f64 (rtol 1e-4, as the f32 CPU check): cells
    through the kernels (one cell_kuf_with_dl launch), points, VFF and B3
    in plain torch (none)."""
    from vggp_tpu_torch import B3SplineFeature, FourierFeature, PointFeature

    rng = np.random.default_rng(1)
    feat, kind = {"cells": (CellIntegralFeature.from_lims(64, 0.0, 1.0), "matern12"),
                  "points": (PointFeature(32, np.linspace(0.0, 1.0, 32)), "matern32"),
                  "vff": (FourierFeature(12, 0.0, 1.0), "matern32"),
                  "b3": (B3SplineFeature(20, 0.0, 1.0), "matern52")}[feature]
    spec = SVGPSpec(kinds=(kind,), features=(feat,), num_data=10_000, learn_mean=True,
                    jitter=1e-6 if kind == "matern12" else 1e-4)
    p_np = convert.params_to_numpy(spec.init_params(torch.float64, "cpu"))
    p_np["axes"][0]["lengthscale"] = np.asarray(0.2)
    p_np["mean"] = np.asarray(0.3)
    p_np["q"]["mu"] = 0.3 * rng.standard_normal(feat.m)
    x = rng.random(512)
    y = np.sin(6 * x) + 0.1 * rng.standard_normal(512)
    want = float(svgp.loss(spec, convert.params_from_jax(p_np, "cpu", torch.float64),
                           torch.tensor(x), torch.tensor(y)))
    ck.reset_launch_counts()
    p = train.tree_map(lambda t: t.requires_grad_(), convert.params_from_jax(p_np, cuda,
                                                                             torch.float32))
    got = svgp.loss(spec, p, torch.tensor(x, dtype=torch.float32, device=cuda),
                    torch.tensor(y, dtype=torch.float32, device=cuda))
    got.backward()
    torch.cuda.synchronize()
    assert ck.LAUNCHES["cell_kuf_with_dl"] == (1 if feature == "cells" else 0)
    np.testing.assert_allclose(float(got.detach()), want, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-12), (torch.float32, 2e-5)])
@pytest.mark.parametrize("m,n", [(512, 16384), (32, 65536), (16, 65536), (60, 65536),
                                 (512, 65536)])
def test_cuda_cell_kernels_at_the_family_shapes(cuda, dtype, rtol, m, n):
    """Both cell kernels at the shapes of the ICM SVGP's steps at 16 384,
    the collapsed ICM GP's, the sum's two components' and the additive
    model's, the fused kernel there too (a at 1e-12 / 2e-5, t at 1e-12 /
    1e-3, the main path's precisions); one launch each."""
    rng = np.random.default_rng(m + n)
    mesh = torch.linspace(0.0, 1.0, m + 1, dtype=torch.float64).to(dtype=dtype, device=cuda)
    x = torch.as_tensor(rng.random(n), dtype=dtype, device=cuda)
    v = torch.tensor(1.3, dtype=dtype, device=cuda)
    ell = torch.tensor(0.27, dtype=dtype, device=cuda)
    ck.reset_launch_counts()
    pairs = [(ck.cell_kuf(mesh, x, v, ell), ck.cell_kuf_plain(mesh, x, v, ell), rtol)]
    pairs += [(g, w, rtol) for g, w in zip(ck.cell_kuf_with_dl(mesh, x, v, ell),
                                           ck.cell_kuf_with_dl_plain(mesh, x, v, ell))]
    fused = m == 512 and n == 65536
    if fused:
        finv = kms.m12_cell_inv_chol(m, 1.0 / m, v, ell, 1e-6)
        got = ck.fused_banded_whiten_kuf(finv, mesh, x, v, ell, "highest", "high")
        want = ck.fused_banded_whiten_kuf_plain(finv, mesh, x, v, ell, "highest", "high")
        pairs += list(zip(got, want, (rtol, 1e-12 if dtype == torch.float64 else 1e-3)))
    torch.cuda.synchronize()
    assert ck.LAUNCHES == {"cell_kuf": 1, "cell_kuf_with_dl": 1,
                           "fused_banded_whiten_kuf": int(fused)}
    for got, want, tol in pairs:
        assert got.shape == want.shape == (m, n)
        assert float((got - want).abs().max() / want.abs().max()) < tol


@pytest.mark.cuda
def test_cuda_cell_kuf_op_backward_matches_plain_and_cpu(cuda):
    """CellKufOp's backward (dσ², dℓ: the training of a cell model on the
    dense route) in f32 at (512, 4096): 1e-5 of the plain version's
    autograd on the card and 1e-4 of CellKufOp in f64 on the CPU; the
    forward one cell_kuf launch."""
    rng = np.random.default_rng(4)
    x64 = rng.random(4096)
    g64 = rng.standard_normal((512, 4096))

    def grads(op, device, dtype):
        mesh = torch.linspace(0.0, 1.0, 513, dtype=torch.float64).to(dtype=dtype, device=device)
        v = torch.tensor(1.3, dtype=dtype, device=device, requires_grad=True)
        ell = torch.tensor(0.27, dtype=dtype, device=device, requires_grad=True)
        x = torch.as_tensor(x64, dtype=dtype, device=device)
        torch.autograd.backward(op(mesh, x, v, ell), torch.as_tensor(g64, dtype=dtype,
                                                                     device=device))
        return torch.stack([v.grad, ell.grad]).double().cpu()

    ck.reset_launch_counts()
    got = grads(ck.cell_kuf_op, cuda, torch.float32)
    assert ck.LAUNCHES["cell_kuf"] == 1
    for want, tol in ((grads(ck.cell_kuf_plain, cuda, torch.float32), 1e-5),
                      (grads(ck.cell_kuf_op, torch.device("cpu"), torch.float64), 1e-4)):
        assert float(((got - want).abs() / want.abs()).max()) < tol


@pytest.mark.cuda
def test_cuda_icm_svgp_matches_cpu_f64(cuda):
    """The ICM SVGP (32×32 Matérn-1/2 cells × 2 outputs, a noise level and
    a mean per output): its loss on the card in f32 against the CPU in f64
    (rtol 1e-4, as the f32 CPU check), cell_kuf twice (the dense route, W
    and κ trained), and its posterior at 256 points (rtol 1e-3)."""
    from vggp_tpu_torch import OutputFeature

    rng = np.random.default_rng(5)
    spec = SVGPSpec(kinds=("matern12", "matern12", "coregion"),
                    features=(CellIntegralFeature.from_lims(32, 0.0, 1.0),
                              CellIntegralFeature.from_lims(32, 0.0, 1.0), OutputFeature(2)),
                    num_data=10_000, variational="kron", per_output_noise=True,
                    learn_mean=True)
    p_np = convert.params_to_numpy(spec.init_params(torch.float64, "cpu"))
    p_np["q"]["mu"] = 0.3 * rng.standard_normal((32, 32, 2))
    p_np["mean"] = np.array([0.2, -0.1])
    X = np.column_stack([rng.random((1024, 2)), rng.integers(0, 2, 1024)])
    y = np.sin(6 * X[:, 0]) * np.cos(5 * X[:, 1]) + 0.1 * rng.standard_normal(1024)
    xs = np.column_stack([rng.random((256, 2)), rng.integers(0, 2, 256)])
    cpu = convert.params_from_jax(p_np, "cpu", torch.float64)
    want = float(svgp.loss(spec, cpu, torch.tensor(X), torch.tensor(y)))
    with torch.no_grad():
        post = svgp.posterior(spec, cpu, torch.tensor(xs))
    ck.reset_launch_counts()
    p = train.tree_map(lambda t: t.requires_grad_(), convert.params_from_jax(p_np, cuda,
                                                                             torch.float32))
    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=cuda)
    got = svgp.loss(spec, p, f32(X), f32(y))
    got.backward()
    torch.cuda.synchronize()
    assert ck.LAUNCHES == {"cell_kuf": 2, "cell_kuf_with_dl": 0, "fused_banded_whiten_kuf": 0}
    np.testing.assert_allclose(float(got.detach()), want, rtol=1e-4)
    with torch.no_grad():
        served = svgp.posterior(spec, train.tree_map(lambda t: t.detach(), p), f32(xs))
    assert gauss_err(served, post) < 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["sum", "additive", "free"])
def test_cuda_collapsed_families_match_cpu_f64(cuda, family):
    """The sum (two Matérn-1/2 cell components), the additive model and the
    free points on 2048 points: the ELBO on the card in f32 against the CPU
    in f64 (rtol 1e-4), with the launches of each route: cell_kuf four
    times (CellKufOp), cell_kuf_with_dl twice (the scalar tangent below the
    fused kernel's batch), none."""
    from vggp_tpu_torch import (AdditiveSGPRSpec, FreeSVGPSpec, SGPRSpec, SumSGPRSpec,
                                additive, freesvgp)
    from vggp_tpu_torch import sum as msum

    rng = np.random.default_rng(6)
    cells = lambda m: tuple(CellIntegralFeature.from_lims(m, 0.0, 1.0) for _ in range(2))
    spec, mod, want_launches = {
        "sum": (SumSGPRSpec(components=tuple(SGPRSpec(kinds=("matern12",) * 2,
                                                      features=cells(m)) for m in (8, 20))),
                msum, {"cell_kuf": 4, "cell_kuf_with_dl": 0}),
        "additive": (AdditiveSGPRSpec(kinds=("matern12",) * 2, features=cells(256)), additive,
                     {"cell_kuf": 0, "cell_kuf_with_dl": 2}),
        "free": (FreeSVGPSpec(kinds=("matern12",) * 2, m=64), freesvgp,
                 {"cell_kuf": 0, "cell_kuf_with_dl": 0})}[family]
    p_np = convert.params_to_numpy(spec.init_params(torch.float64, "cpu"))
    X = rng.random((2048, 2))
    y = np.sin(6 * X[:, 0]) * np.cos(5 * X[:, 1]) + 0.1 * rng.standard_normal(2048)
    want = float(mod.loss(spec, convert.params_from_jax(p_np, "cpu", torch.float64),
                          torch.tensor(X), torch.tensor(y)))
    ck.reset_launch_counts()
    p = train.tree_map(lambda t: t.requires_grad_(), convert.params_from_jax(p_np, cuda,
                                                                             torch.float32))
    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=cuda)
    got = mod.loss(spec, p, f32(X), f32(y))
    got.backward()
    torch.cuda.synchronize()
    assert ck.LAUNCHES == {**want_launches, "fused_banded_whiten_kuf": 0}
    np.testing.assert_allclose(float(got.detach()), want, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-12), (torch.float32, 2e-5)])
@pytest.mark.parametrize("m,n,edges", [(16384, 256, False), (512, 513, True)])
def test_cuda_cell_kuf_at_the_matrix_free_shapes(cuda, dtype, rtol, m, n, edges):
    """cell_kuf at the matrix-free path's new shapes: bench.py's CG case,
    16 384 cells against 256 points (m ≫ n), and the face difference of
    grad_grid_kvu, 512 cells against their own 513 edges; one launch each."""
    mesh = torch.linspace(0.0, 1.0, m + 1, dtype=torch.float64).to(dtype=dtype, device=cuda)
    x = (mesh.clone() if edges else
         torch.as_tensor(np.sort(np.random.default_rng(14).uniform(size=n)), dtype=dtype,
                         device=cuda))
    v = torch.tensor(1.0, dtype=dtype, device=cuda)
    ell = torch.tensor(0.25, dtype=dtype, device=cuda)
    ck.reset_launch_counts()
    got = ck.cell_kuf(mesh, x, v, ell)
    want = ck.cell_kuf_plain(mesh, x, v, ell)
    torch.cuda.synchronize()
    assert ck.LAUNCHES == {"cell_kuf": 1, "cell_kuf_with_dl": 0, "fused_banded_whiten_kuf": 0}
    assert ck.SHAPE_LAUNCHES == {("cell_kuf", m, n): 1}
    assert got.shape == want.shape == (m, n)
    assert float((got - want).abs().max() / want.abs().max()) < rtol


@pytest.mark.cuda
def test_cuda_solve_w_at_512_cells_matches_float64(cuda):
    """solve_w on 512×512 Matérn-1/2 cells (m = 262 144) as phase 13a runs
    it: phase 4's trained hyperparameters (as tools/torch_cg_probe.py prints
    them) on the first 65 536 of chip_smoke's points (Jacobi CG, above
    CG_KMS_MAX_POINTS), cell_kuf once an axis. The float32 solve at the
    default maxiter reaches a true relative residual (recomputed in float64)
    within chip_smoke.TOL_MF_RESID, and the float32 q_v head from the
    float64 solve's w (3000 iterations) lies within the 2× rule of the
    float64 head, against the CPU's float32."""
    import chip_smoke
    from chip_smoke import CPU_ERR_RATIO, TOL_E2E_POST, TOL_MF_RESID
    from vggp_tpu_torch import SGPRSpec, iterative

    X, y, _ = chip_smoke.make_data(cuda)
    X, y = X[:65536], y[:65536]
    spec = SGPRSpec(kinds=("matern12",) * 2,
                    features=tuple(CellIntegralFeature.from_lims(512, 0.0, 1.0) for _ in range(2)))

    def params(dtype, device=cuda):
        t = lambda a: torch.tensor(a, dtype=torch.float32).to(dtype=dtype, device=device)
        return {"axes": tuple({"variance": t(0.9110044240951538), "lengthscale": t(ell)}
                              for ell in (1.0736465454101562, 1.0830117464065552)),
                "noise": t(0.11434642970561981)}

    out = {}
    for dtype, maxiter in ((torch.float32, 1000), (torch.float64, 3000)):
        ck.reset_launch_counts()
        w, info = iterative.solve_w(spec, params(dtype), X.to(dtype), y.to(dtype),
                                    maxiter=maxiter, return_info=True)
        torch.cuda.synchronize()
        assert ck.LAUNCHES == {"cell_kuf": 2, "cell_kuf_with_dl": 0, "fused_banded_whiten_kuf": 0}
        assert info["preconditioner"] == "jacobi"
        out[dtype] = w
    w32, w64 = out[torch.float32], out[torch.float64]
    rel = float(iterative.relative_residual(spec, params(torch.float64), X.double(), y.double(),
                                            w32))
    assert rel <= TOL_MF_RESID, rel
    qv = lambda p, w: iterative.q_v_mean_from_w(spec, p, spec.features, w).double().cpu()
    want = qv(params(torch.float64), w64)
    err = lambda got: float((got - want).abs().max() / want.abs().max())
    e, e32 = err(qv(params(torch.float32), w64.float())), err(qv(params(torch.float32, "cpu"),
                                                                w64.float().cpu()))
    assert e <= max(TOL_E2E_POST, CPU_ERR_RATIO * e32), (e, e32)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["svgp kron", "svgp full", "collapsed"])
def test_cuda_samplers_match_cpu_f64(cuda, family):
    """``sampling.pathwise`` and ``pathwise_q_v`` in float64 on the card and
    on the CPU from one CPU generator (so the same draws): rtol 1e-9, with
    cell_kuf launched once an axis for the query block, and for each
    factored state of the collapsed GP, on the card only."""
    from vggp_tpu_torch import SGPRSpec, sampling

    rng = np.random.default_rng(21)
    X = rng.random((2048, 2))
    y = np.sin(6 * X[:, 0]) * np.cos(5 * X[:, 1]) + 0.1 * rng.standard_normal(2048)
    xs = rng.random((512, 2))
    cells = tuple(CellIntegralFeature.from_lims(m, 0.0, 1.0) for m in (64, 48))
    if family == "collapsed":
        spec = SGPRSpec(kinds=("matern12",) * 2, features=cells)
    else:
        spec = SVGPSpec(kinds=("matern12",) * 2, features=cells, num_data=2048,
                        variational=family.split()[1], learn_mean=True)
    p = spec.init_params(torch.float64, device="cpu")
    for ax, ell in zip(p["axes"], (0.2, 0.3)):
        ax["lengthscale"] = torch.tensor(ell, dtype=torch.float64)
    if family != "collapsed":
        g = torch.Generator().manual_seed(1)
        p["q"] = {k: (0.3 * torch.randn(v.shape, generator=g, dtype=torch.float64) if k == "mu"
                      else torch.eye(v.shape[0], dtype=torch.float64) * 0.2)
                  for k, v in p["q"].items()}
        p["mean"] = torch.tensor(0.1, dtype=torch.float64)
    grid = tuple(CellIntegralFeature.from_lims(m, 0.0, 1.0) for m in (20, 24))
    out = {}
    for dev in (torch.device("cpu"), cuda):
        c = lambda t: train.tree_map(lambda v: v.to(dev), t)
        data = (c(torch.as_tensor(X)), c(torch.as_tensor(y))) if family == "collapsed" else None
        ck.reset_launch_counts()
        with torch.no_grad():
            f = sampling.pathwise(spec, c(p), torch.Generator().manual_seed(5),
                                  c(torch.as_tensor(xs)), data=data, n_samples=6,
                                  n_features=256)
            v = sampling.pathwise_q_v(spec, c(p), torch.Generator().manual_seed(6), grid,
                                      n_samples=6, n_features=256, data=data)
        torch.cuda.synchronize()
        want = {"svgp kron": 2, "svgp full": 2, "collapsed": 6}[family]
        assert ck.LAUNCHES["cell_kuf"] == (want if dev.type == "cuda" else 0)
        out[dev.type] = (f.cpu(), v.cpu())
    for got, want in zip(out["cuda"], out["cpu"]):
        assert got.shape == want.shape
        assert float((got - want).abs().max() / want.abs().max()) < 1e-9


@pytest.mark.cuda
def test_cuda_assimilate_matches_cpu_f64(cuda):
    """``streaming.assimilate`` of 4096 points in two chunks on a 2-D
    full-family spec (24×24 Matérn-1/2 cells) and ``to_params`` → q_v, in
    float64 on the card and on the CPU: rtol 1e-10; cell_kuf twice a chunk
    on the card."""
    from vggp_tpu_torch import streaming

    rng = np.random.default_rng(22)
    X = torch.as_tensor(rng.random((4096, 2)))
    y = torch.as_tensor(np.sin(6 * X[:, 0].numpy()) + 0.1 * rng.standard_normal(4096))
    cells = tuple(CellIntegralFeature.from_lims(24, 0.0, 1.0) for _ in range(2))
    spec = SVGPSpec(kinds=("matern12",) * 2, features=cells, num_data=4096)
    out = {}
    for dev in (torch.device("cpu"), cuda):
        p = spec.init_params(torch.float64, device=dev)
        p["noise"] = torch.tensor(0.02, dtype=torch.float64, device=dev)
        s = streaming.init_state(spec, torch.float64, device=dev)
        ck.reset_launch_counts()
        for lo in (0, 2048):
            s = streaming.assimilate(spec, p, s, X[lo:lo + 2048].to(dev), y[lo:lo + 2048].to(dev))
        q = svgp.q_v(spec, streaming.to_params(spec, p, s), cells, full_cov=False)
        torch.cuda.synchronize()
        assert ck.LAUNCHES["cell_kuf"] == (4 if dev.type == "cuda" else 0)
        out[dev.type] = [t.cpu() for t in (s["lam"], s["eta"], q.mean, q.var)]
    for got, want in zip(out["cuda"], out["cpu"]):
        assert float((got - want).abs().max() / want.abs().max()) < 1e-10


def _case_1d(dev):
    """ROADMAP queue 3, item 16's 1-D case (32 Matérn-1/2 cells, 200
    points, σ² 1.3, ℓ 0.08, noise 0.02) in float64 on ``dev``: (params,
    loss)."""
    from vggp_tpu_torch import SGPRSpec, sgpr

    rng = np.random.default_rng(0)
    x = rng.random(200)
    y = np.sin(6 * x) + 0.05 * rng.standard_normal(200)
    spec = SGPRSpec(kinds=("matern12",), features=(CellIntegralFeature.from_lims(32, 0.0, 1.0),))
    t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=dev)
    X, Y = t(x), t(y)
    p = {"axes": ({"variance": t(1.3), "lengthscale": t(0.08)},), "noise": t(0.02)}
    return p, lambda q: sgpr.loss(spec, q, X, Y)


@pytest.mark.cuda
def test_cuda_second_order_route_matches_cpu(cuda):
    """The Hessian of ``hyperpost.laplace`` through ``second_order()`` on the
    card (the ``cell_kuf`` kernel forward under CellKufOp, its plain-torch
    backward twice) against the CPU's: rtol 1e-10 of max|H|, float64; the
    route launches cell_kuf, never the tangent kernels."""
    from vggp_tpu_torch import hyperpost

    out = {}
    for dev in (torch.device("cpu"), cuda):
        p, loss = _case_1d(dev)
        ck.reset_launch_counts()
        H, *_ = hyperpost.raw_hessian(loss, p)
        torch.cuda.synchronize()
        if dev.type == "cuda":
            assert ck.LAUNCHES["cell_kuf"] > 0 and ck.LAUNCHES["cell_kuf_with_dl"] == 0
        out[dev.type] = H.cpu()
    assert float((out["cuda"] - out["cpu"]).abs().max() / out["cpu"].abs().max()) < 1e-10


@pytest.mark.cuda
def test_cuda_hmc_matches_cpu_from_one_generator(cuda):
    """A short HMC (2 chains, 4 warmup, 8 draws, 4 leapfrog steps) on the
    1-D case in float64 from one Laplace state (the CPU's), the draws from
    one CPU generator seeded the same:
    the card's raw draws, step sizes and accept rate against the CPU's at
    rtol 1e-8; the leapfrog's gradients launch cell_kuf_with_dl."""
    from vggp_tpu_torch import hyperpost

    p, loss = _case_1d("cpu")
    st_cpu = hyperpost.laplace(loss, p)     # one state: eigenvector signs differ by device
    out = {}
    for dev in (torch.device("cpu"), cuda):
        p, loss = _case_1d(dev)
        st = st_cpu._replace(mean=st_cpu.mean.to(dev), chol_cov=st_cpu.chol_cov.to(dev),
                             logdet_h=st_cpu.logdet_h.to(dev))
        ck.reset_launch_counts()
        r = hyperpost.hmc_sample_params(loss, st, torch.Generator().manual_seed(3), n_samples=8,
                                        n_chains=2, n_warmup=4, n_leapfrog=4)
        torch.cuda.synchronize()
        if dev.type == "cuda":
            assert ck.LAUNCHES["cell_kuf_with_dl"] > 0
        out[dev.type] = [t.cpu() for t in (r.raw_draws, r.step_size, r.accept_rate)]
    for got, want in zip(out["cuda"], out["cpu"]):
        assert float((got - want).abs().max() / want.abs().max()) < 1e-8


@pytest.mark.cuda
def test_cuda_checkpoint_loads_with_map_location(cuda, tmp_path):
    """A parameter tree saved on the card loads bitwise onto the CPU and back
    onto the card with ``map_location``, tuples restored by ``like``."""
    cells = tuple(CellIntegralFeature.from_lims(16, 0.0, 1.0) for _ in range(2))
    spec = SVGPSpec(kinds=("matern12",) * 2, features=cells, num_data=100)
    p = spec.init_params(torch.float32, device=cuda)
    p["q"]["mu"] = torch.randn(p["q"]["mu"].shape, device=cuda)
    train.save_checkpoint(str(tmp_path), p, step=2)
    on_cpu = train.load_checkpoint(str(tmp_path), step=2, like=p, map_location="cpu")
    back = train.load_checkpoint(str(tmp_path), step=2, like=p, map_location=cuda)
    assert isinstance(back["axes"], tuple)
    for a, b, c in zip(train.tree_leaves(p), train.tree_leaves(on_cpu), train.tree_leaves(back),
                       strict=True):
        assert b.device.type == "cpu" and c.device.type == "cuda"
        assert torch.equal(a.cpu(), b) and torch.equal(a, c)


@pytest.mark.cuda
def test_cuda_facade_lands_on_the_card(cuda, tmp_path):
    """An ``api.SVGP`` built with no ``device`` holds its params on the card
    and fits there through the cell kernels; a checkpoint written from the
    CPU restores onto the card (``restore`` maps to the facade's device),
    bitwise, and the facade's ``q_v`` then equals the CPU facade's."""
    from vggp_tpu_torch import api

    rng = np.random.default_rng(23)
    X = rng.random((2048, 2))
    y = np.sin(6 * X[:, 0]) * np.cos(5 * X[:, 1]) + 0.1 * rng.standard_normal(2048)
    m = api.SVGP.gridded((24, 24), (0.0, 1.0), num_data=2048, dtype=torch.float64)
    assert m.device.type == "cuda"
    assert all(v.device.type == "cuda" for v in train.tree_leaves(m.params))
    ck.reset_launch_counts()
    m.fit(X, y, n_iters=3, batch_size=512)
    assert ck.LAUNCHES["cell_kuf_with_dl"] == 6
    host = api.SVGP(m.spec, params=train.tree_map(lambda v: v.cpu(), m.params), device="cpu",
                    dtype=torch.float64)
    host.save(str(tmp_path))
    back = api.SVGP.gridded((24, 24), (0.0, 1.0), num_data=2048,
                            dtype=torch.float64).restore(str(tmp_path))
    for a, b in zip(train.sorted_leaves(m.params), train.sorted_leaves(back.params),
                    strict=True):
        assert b.device.type == "cuda" and torch.equal(a, b)
    got, want = back.q_v(), host.q_v()
    torch.cuda.synchronize()
    for g, w in ((got.mean, want.mean), (got.var, want.var)):
        assert g.device.type == "cuda"
        assert float((g.cpu() - w).abs().max() / w.abs().max()) < 1e-10


@pytest.mark.cuda
def test_cuda_world_one_sharded_step_equals_the_unsharded_step(cuda, tmp_path):
    """On a world-1 NCCL group (a FileStore, no network) with a ("data",
    "model") mesh on the card, three steps of ``make_sharded_svgp_step``
    equal three of ``train.make_step_fn`` on the same batches: every
    collective of a world of one is an identity, so the losses and every raw
    leaf are expected bitwise (held at 1e-6 relative), through the same
    kernel launches."""
    import torch.distributed as dist

    from vggp_tpu_torch import parallel

    rng = np.random.default_rng(29)
    X = torch.as_tensor(rng.random((4096, 2)), dtype=torch.float32, device=cuda)
    y = torch.sin(6 * X[:, 0]) * torch.cos(5 * X[:, 1])
    spec = SVGPSpec(kinds=("matern12", "matern12"),
                    features=tuple(CellIntegralFeature.from_lims(64, 0.0, 1.0) for _ in range(2)),
                    num_data=4096, variational="kron")
    params = train.non_informative_init(spec.init_params(torch.float32, cuda), X, y)
    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1)
    try:
        mesh = parallel.make_mesh(("data", "model"), (1, 1))
        init_fn, step_fn = parallel.make_sharded_svgp_step(
            spec, lambda ps: torch.optim.Adam(ps, lr=1e-2), mesh)
        raw, opt = init_fn(params)
        raw0 = train.raw_leaves_from(params)
        step0 = train.make_step_fn(lambda p, xb, yb: svgp.loss(spec, p, xb, yb), raw0,
                                   torch.optim.Adam(train.tree_leaves(raw0), lr=1e-2))
        for k in range(3):
            idx = torch.arange(k * 1024, (k + 1) * 1024, device=cuda)
            ck.reset_launch_counts()
            raw, opt, loss = step_fn(raw, opt, *parallel.shard_batch(X[idx], y[idx], mesh))
            torch.cuda.synchronize()
            sharded = dict(ck.LAUNCHES)
            ck.reset_launch_counts()
            loss0 = step0(X[idx], y[idx])
            torch.cuda.synchronize()
            assert sharded == dict(ck.LAUNCHES) and sharded["cell_kuf_with_dl"] == 2
            assert abs(float(loss) - float(loss0)) <= 1e-6 * abs(float(loss0))
        for a, b in zip(train.tree_leaves(raw), train.tree_leaves(raw0), strict=True):
            a, b = a.detach(), b.detach()
            assert a.device.type == "cuda"
            assert float((a - b).abs().max()) <= 1e-6 * max(float(b.abs().max()), 1e-30)
    finally:
        dist.destroy_process_group()
