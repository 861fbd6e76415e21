"""Probe the matrix-free CG path on the card at the main path's width.

    python3 tools/torch_cg_probe.py [--maxiters 1000,4000] [--samples-n 4096,65536]
                                    [--draws-maxiters 1000,2000,4000]

Trains the 512×512-cell SVGP of ``chip_smoke.drive_main_path`` (phase 4),
takes its kernel hyperparameters and noise into a collapsed ``SGPRSpec`` and
runs ``iterative.solve_w`` on the first 65 536 of its points in float32 and
float64 at each maxiter: iterations, the relative residual recomputed in
float64, ms, ms per iteration, the preconditioner, and the q_v mean on the
512² cells against the float64 solve at the largest maxiter. Then times
``q_v_pathwise`` (S = 16 antithetic, 1024 features) in float32 at each n of
``--samples-n``, with its CG iterations. With ``--draws-maxiters``, draws
phase 13c's samples (``pathwise_q_v_samples`` on the first 16 384 points,
S = 16 antithetic, 1024 features, seed 13) in float32 and float64 at each
maxiter of the G solves and prints the float32 draws' and variances'
distance from the float64 ones at that maxiter and from the float64 draws at
the largest one, and the largest float32/float64 variance ratio. An empty
list skips a part. Prints the card's name and power limit first. Needs a
CUDA card.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--maxiters", default="1000,4000")
    ap.add_argument("--samples-n", default="4096,65536")
    ap.add_argument("--draws-maxiters", default="")
    args = ap.parse_args()
    ints = lambda text: [int(v) for v in text.split(",") if v]
    if not torch.cuda.is_available():
        print("torch_cg_probe: needs a CUDA card", file=sys.stderr)
        return 2
    print(chip_smoke.card_line())
    from vggp_tpu_torch import SGPRSpec, iterative
    from vggp_tpu_torch.ops import _build, cg

    _build.load()
    device = torch.device("cuda")
    X, y, Xs = chip_smoke.make_data(device)
    spec_svgp, model, *_ = chip_smoke.drive_main_path(device, X, y, Xs)
    spec = SGPRSpec(kinds=spec_svgp.kinds, features=spec_svgp.features)
    with torch.no_grad():
        p = model.params()
    p = {"axes": p["axes"], "noise": p["noise"]}
    print("params:", {f"ell_{i}": float(a["lengthscale"]) for i, a in enumerate(p["axes"])},
          {f"var_{i}": float(a["variance"]) for i, a in enumerate(p["axes"])},
          "noise", float(p["noise"]))
    n = 65536
    cast = lambda t, dt: chip_smoke.cast_to(device, dt)(t)
    p64, X64, y64 = (cast(t, torch.float64) for t in (p, X[:n], y[:n]))
    maxiters = ints(args.maxiters)
    qv = {}
    for dt in (torch.float32, torch.float64):
        pd, Xd, yd = (cast(t, dt) for t in (p, X[:n], y[:n]))
        for mi in maxiters:
            cg.reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            w, info = iterative.solve_w(spec, pd, Xd, yd, maxiter=mi, return_info=True)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            rel = float(iterative.relative_residual(spec, p64, X64, y64, w))
            qv[(dt, mi)] = iterative.q_v_mean_from_w(spec, pd, spec.features, w).double()
            print(f"solve_w {str(dt)[6:]} maxiter {mi}: {info}, true rel resid {rel:.3e}, "
                  f"{ms:.1f} ms, {ms / max(info['iterations'], 1):.3f} ms/iteration, "
                  f"counts {dict(cg.COUNTS)}", flush=True)
    ref = qv.get((torch.float64, maxiters[-1])) if maxiters else None
    for k, v in qv.items():
        print(f"q_v {str(k[0])[6:]} maxiter {k[1]} vs f64 maxiter {maxiters[-1]}: "
              f"rel {chip_smoke.rel_err(v, ref):.3e}")
    for ns in ints(args.samples_n):
        gen = torch.Generator(device=device).manual_seed(0)
        cg.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g = iterative.q_v_pathwise(spec, p, X[:ns], y[:ns], spec.features, gen, n_samples=16,
                                   antithetic=True, control_variate=True)
        torch.cuda.synchronize()
        print(f"q_v_pathwise f32 n={ns}: {time.perf_counter() - t0:.2f} s, counts "
              f"{dict(cg.COUNTS)}, var range [{float(g.var.min()):.3e}, "
              f"{float(g.var.max()):.3e}]", flush=True)
    draws = {}
    ns = chip_smoke.MF_PATH_N
    for mi in ints(args.draws_maxiters):
        for dt in (torch.float32, torch.float64):
            pd, Xd, yd = (cast(t, dt) for t in (p, X[:ns], y[:ns]))
            gen = torch.Generator(device=device).manual_seed(13)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.no_grad():
                s = iterative.pathwise_q_v_samples(spec, pd, Xd, yd, spec.features, gen,
                                                   n_samples=16, n_features=1024,
                                                   antithetic=True, maxiter=mi)
            torch.cuda.synchronize()
            draws[dt, mi] = s.double()
            print(f"draws {str(dt)[6:]} maxiter {mi}: {time.perf_counter() - t0:.1f} s", flush=True)
    if draws:
        last = draws[torch.float64, ints(args.draws_maxiters)[-1]]
        for mi in ints(args.draws_maxiters):
            s32, s64 = draws[torch.float32, mi], draws[torch.float64, mi]
            ratio = float((s32.var(0) / s64.var(0).clamp(min=1e-300)).max())
            print(f"draws maxiter {mi}: f32 vs f64 {chip_smoke.rel_err(s32, s64):.3e} (variances "
                  f"{chip_smoke.rel_err(s32.var(0), s64.var(0)):.3e}, largest ratio {ratio:.3f}); "
                  f"vs f64 at maxiter {ints(args.draws_maxiters)[-1]}: f32 "
                  f"{chip_smoke.rel_err(s32, last):.3e}, f64 {chip_smoke.rel_err(s64, last):.3e}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
