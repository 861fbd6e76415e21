"""Phase 20 of ``chip_smoke.py`` alone on the card: build the kernels, run
phase 4's path (so the process is warm, as in the whole script), then the
phase-17 hold and timings of ``P20_TIMED_SHAPES`` and ``experiments_phase``
(20a, 20b, 20c).

    python3 tools/torch_phase20_alone.py

About 3 minutes of command time on an H100. With ``--profiler-probe with``
or ``--profiler-probe without`` it instead runs phase 4's path, 20a or not,
phase 16's profiled steps and seven of phase 17's kernel timings, and
prints how many timings kept enough launches (the trace loss of ROADMAP
queue 2b, item 4).
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from vggp_tpu_torch.ops import _build  # noqa: E402

PROBE_SHAPES = ((512, 65536, "cell_kuf"), (512, 513, "cell_kuf"), (16384, 256, "cell_kuf"),
                (64, 65536, "cell_kuf"), (64, 4096, "cell_kuf"),
                (64, 4096, "cell_kuf_with_dl"), (20, 4400, "cell_kuf_with_dl"))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profiler-probe", choices=("with", "without"), default=None)
    args = ap.parse_args()
    device = torch.device("cuda")
    card = cs.card_line()
    print("card:", card, torch.__version__, torch.version.cuda,
          "threads", torch.get_num_threads())
    t0 = time.perf_counter()
    _build.load()
    print(f"build {time.perf_counter() - t0:.1f} s")
    X, y, Xs = cs.make_data(device)
    _, _, _, _, _, step, gen = cs.drive_main_path(device, X, y, Xs)
    if args.profiler_probe is not None:
        if args.profiler_probe == "with":
            cs.experiments_cpu_part(device)
        for batch in (cs.TRAIN_BATCH, cs.FUSED_BATCH):
            cs.profile_steps(step, X, y, batch, gen)
        ok = 0
        for m, n, name in PROBE_SHAPES:
            try:
                cs.time_kuf_shape(device, m, n, name=name, x_is_mesh=(n == m + 1))
                ok += 1
            except RuntimeError as e:   # the trace kept too few launches
                print("FAILED", m, n, name, e)
        print(f"PROBE {args.profiler_probe}: {ok} of {len(PROBE_SHAPES)} timings")
        return
    cs.check_kernels_at(device, cs.p20_cases(device, cs.P20_TIMED_SHAPES), "20")
    for kernel, m, n in cs.P20_TIMED_SHAPES:
        e = cs.time_kuf_shape(device, m, n, name=kernel)
        print(f"P20 TIMED {kernel} ({m}, {n}): {e['ms']:.5f} ms, bound {e['bound_ms']:.6f}, "
              f"share {e['bound_ms'] / e['ms']:.3f}, plain {e['plain_ms']:.5f}")
    got, _, at = cs.experiments_phase(device, card)
    print("P20 DONE", got, dict(sorted(at.items())))


if __name__ == "__main__":
    main()
