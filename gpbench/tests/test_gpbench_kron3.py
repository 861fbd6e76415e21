"""The three-axis configuration's pieces of the benchmark on the CPU: its plain
reference against the model built whole from its definitions, and the least
time of its contraction and of its step."""

import math

import pytest
import torch

from gpbench import contract, costs, readers
from gpbench.families import svgp_kron3 as fam
from gpbench.reference import cells_m12
from gpbench.reference import svgp_kron3 as ref
from gpbench.reference.precision import REFERENCE

CFG = {"cells": [4, 3, 2], "domain": [[0.0, 1.0]] * 3, "num_data": 500, "rel_jitter": 1e-6,
       "floors": {"noise": 1e-06, "variance": 1e-08, "lengthscale": 1e-08}}


def _kron(mats):
    out = mats[0]
    for m in mats[1:]:
        out = torch.kron(out, m)
    return out


def _dense_loss(cfg, raw, x, y):
    """−ELBO of the whole model: Kuu = ⊗Kuu_i (each jittered) and its
    Cholesky factor F, Kuf the rows' Kronecker of the axes', a = F⁻¹Kuf,
    S = ⊗L_iL_iᵀ, and the KL of N(μ, S) from N(0, I) by its definition."""
    p = ref.constrain(cfg, raw)
    mesh = ref.meshes(cfg, x)
    kuu = _kron([cells_m12.jittered(cells_m12.kuu(mesh[i], p["variance"][i],
                                                  p["lengthscale"][i]), cfg["rel_jitter"])
                 for i in range(3)])
    kufs = [cells_m12.kuf(mesh[i], x[:, i], p["variance"][i], p["lengthscale"][i])
            for i in range(3)]
    kuf = torch.stack([_kron([k[:, j:j + 1] for k in kufs])[:, 0]
                       for j in range(x.shape[0])], dim=1)
    a = torch.linalg.solve_triangular(torch.linalg.cholesky(kuu), kuf, upper=False)
    S = _kron([L @ L.T for L in p["L"]])
    mu = p["mu"].reshape(-1)
    mean = a.T @ mu
    kff = p["variance"][0] * p["variance"][1] * p["variance"][2]
    var_f = torch.clamp(kff - torch.sum(a * a, dim=0), min=0.0) + torch.sum(a * (S @ a), dim=0)
    noise = p["noise"]
    ell = -0.5 * torch.log(2.0 * math.pi * noise) - ((y - mean) ** 2 + var_f) / (2.0 * noise)
    kl = 0.5 * (torch.trace(S) + mu @ mu - mu.shape[0] - torch.logdet(S))
    return -(cfg["num_data"] / y.shape[0]) * torch.sum(ell) + kl


@pytest.mark.parametrize("seed", [1, 2**31 + 7])
def test_reference_matches_the_model_built_whole(seed):
    g = torch.Generator().manual_seed(seed)
    ms = CFG["cells"]
    p = {"variance": [torch.tensor(0.5 + float(torch.rand((), generator=g)),
                                   dtype=torch.float64) for _ in ms],
         "lengthscale": [torch.tensor(0.2 + float(torch.rand((), generator=g)),
                                      dtype=torch.float64) for _ in ms],
         "noise": torch.tensor(0.1, dtype=torch.float64),
         "mu": torch.randn(ms, generator=g, dtype=torch.float64),
         "L": [torch.tril(0.3 * torch.randn((m, m), generator=g, dtype=torch.float64), -1)
               + torch.diag(0.5 + torch.rand((m,), generator=g, dtype=torch.float64))
               for m in ms]}
    x = torch.rand((40, 3), generator=g, dtype=torch.float64)
    y = torch.randn((40,), generator=g, dtype=torch.float64)
    raw = ref.raw_from_constrained(CFG, p)
    loss, grads = ref.loss_and_grad(CFG, raw, x, y, REFERENCE, block=16)
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in raw.items()}
    want = _dense_loss(CFG, leaves, x, y)
    want.backward()
    # float64 on both sides, the whole model's Cholesky against the axes'
    assert float(loss) == pytest.approx(float(want.detach()), rel=1e-10)
    for k, leaf in leaves.items():
        torch.testing.assert_close(grads[k], leaf.grad, rtol=1e-8,
                                   atol=1e-8 * float(leaf.grad.abs().max()), msg=k)
    mean, var = ref.posterior(CFG, p, x, REFERENCE, block=16)
    assert mean.shape == var.shape == (40,) and bool((var > 0).all())


def test_contract_bound_at_the_cell():
    """Three products of 512·512·42·4096 FMAs at the bf16x6 peak: 1.64 ms,
    above the 0.04 ms of μ read twice and ∂μ written."""
    m = 512 * 512 * 42
    assert contract.fmas(m, 4096) == 3 * m * 4096
    assert contract.bound_s(m, 4096) * 1e3 == pytest.approx(1.6416, abs=1e-4)
    assert 3 * m * costs.F4 / costs.HBM_BYTES_PER_S < contract.bound_s(m, 4096)
    shapes = {("kron_contract", m, 4096): 60, ("cell_kuf_with_dl", 512, 4096): 120}
    assert contract.window_bound_s(shapes) == pytest.approx(60 * contract.bound_s(m, 4096))


def test_family_fit_fmas():
    """Each axis's own terms as the two-axis count has them, and three
    contractions in place of the five that count gives at three axes."""
    cfg = {"cells": [512, 512, 42]}
    got = fam.fit_fmas(cfg, 4096)
    m = 512 * 512 * 42
    assert got["bf16x6"] == pytest.approx(
        2 * costs.svgp_kron_fit_fmas([512], 4096)["bf16x6"] + 3 * m * 4096)
    assert got["fp32"] == pytest.approx(sum(costs.svgp_kron_fit_fmas([k], 4096)["fp32"]
                                            for k in cfg["cells"]))
    assert costs.least_seconds(got) < costs.least_seconds(
        costs.svgp_kron_fit_fmas(cfg["cells"], 4096))
    assert costs.least_seconds(got) * 1e3 == pytest.approx(1.787, abs=1e-3)


def _metric(name):
    from gpbench import harness

    return harness.load_module(harness.BENCH_DIR / "metrics" / f"{name}.py", f"t_{name}")


def test_contract_readers():
    m = 512 * 512 * 42
    bound = 60 * contract.bound_s(m, 4096)
    rec = {"kind": "fit", "shape_launches": {("kron_contract", m, 4096): 60},
           "trace": {"units": 60, "spans": {"count": {contract.SPAN: 120},
                                            "device_s": {contract.SPAN: 2 * bound}}}}
    roof, ms = _metric("kron_contract_roofline"), _metric("device_ms_per_step.contract.fit")
    assert roof.read(rec) == pytest.approx(50.0)
    assert ms.read(rec) == pytest.approx(1e3 * 2 * bound / 60)
    # a program without the span (the parent's), or a window without a device
    for spans in ({"count": {"vggp.model.moments": 60}, "device_s": {}},
                  {"count": {contract.SPAN: 120}, "device_s": {}}):
        rec["trace"]["spans"] = spans
        assert roof.read(rec) is None
    assert ms.read(rec) == 0.0
    rec["trace"]["spans"] = {"count": {}, "device_s": {}}
    assert ms.read(rec) is None
    assert readers.traced({"kind": "serve"}, "fit") is None
