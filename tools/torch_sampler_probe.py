"""Where a pathwise sampler's time goes at the main path's width, on the card.

    python3 tools/torch_sampler_probe.py [--samples 256] [--features 2048]

Trains the 512×512-cell Kronecker SVGP of ``chip_smoke.drive_main_path``
(phase 4) and times, in float32 under ``no_grad`` (host clock ending in
``synchronize``), ``sampling.pathwise`` at its 4096 serve points and
``sampling.pathwise_q_v`` on its 512² cells with the draws from a CPU
``torch.Generator`` (as chip_smoke's phase 14 takes them) and from a CUDA
one, and the host time of one sample's standard normals z (512² float64
values) from the CPU generator, the part of a sample that the CUDA
generator moves to the card. Prints the card's name and power limit first.
Needs a CUDA card.
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
    ap.add_argument("--samples", type=int, default=chip_smoke.P14_SAMPLES)
    ap.add_argument("--features", type=int, default=chip_smoke.P14_FEATURES)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_sampler_probe: needs a CUDA card", file=sys.stderr)
        return 2
    print(chip_smoke.card_line())
    from vggp_tpu_torch import sampling, train
    from vggp_tpu_torch.ops import _build

    _build.load()
    device = torch.device("cuda")
    X, y, Xs = chip_smoke.make_data(device)
    spec, model, *_ = chip_smoke.drive_main_path(device, X, y, Xs)
    with torch.no_grad():
        params = train.tree_map(lambda v: v.detach(), model.params())
    S, F = args.samples, args.features
    calls = {
        "pathwise": lambda g: sampling.pathwise(spec, params, g, Xs, n_samples=S, n_features=F),
        "pathwise_q_v": lambda g: sampling.pathwise_q_v(spec, params, g, spec.features,
                                                        n_samples=S, n_features=F)}
    for name, fn in calls.items():
        for where in ("cpu", "cuda", "cpu", "cuda"):
            gen = torch.Generator(device=where).manual_seed(0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.no_grad():
                out = fn(gen)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            print(f"{name} S={S} F={F}, {where} generator: {ms:.1f} ms ({ms / S:.3f} ms a "
                  f"sample), output {tuple(out.shape)}")
            del out
    gen = torch.Generator().manual_seed(0)
    t0 = time.perf_counter()
    for _ in range(20):
        torch.randn(spec.axis_m, generator=gen, dtype=torch.float64)
    print(f"one sample's z ({spec.axis_m}, float64) from the CPU generator: "
          f"{(time.perf_counter() - t0) / 20 * 1e3:.3f} ms on the host")
    return 0


if __name__ == "__main__":
    sys.exit(main())
