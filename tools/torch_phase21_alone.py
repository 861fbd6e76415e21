"""Phase 21 of ``chip_smoke.py`` alone on the card: build the kernels, hold
and time ``P21_TIMED_SHAPES`` as phase 17 does, then
``experiments_phase21`` (21a, 21b, 21c) and print the kernel rows'
phase-21 entries.

    python3 tools/torch_phase21_alone.py

About 3 minutes of command time on an H100.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from vggp_tpu_torch.ops import _build  # noqa: E402


def main() -> None:
    device = torch.device("cuda")
    card = cs.card_line()
    print("card:", card, torch.__version__, torch.version.cuda,
          "threads", torch.get_num_threads())
    t0 = time.perf_counter()
    _build.load()
    print(f"build {time.perf_counter() - t0:.1f} s")
    errs = cs.check_kernels_at(device, cs.p20_cases(device, cs.P21_TIMED_SHAPES), "21")
    rows = {}
    for kernel, m, n in cs.P21_TIMED_SHAPES:
        entry = cs.time_kuf_shape(device, m, n, name=kernel)
        entry.update(share_of_bound=entry["bound_ms"] / entry["ms"],
                     max_abs_err=errs[(kernel, m, n)])
        rows[f"{kernel} {m}x{n}"] = entry
    launches, timings, at = cs.experiments_phase21(device, card)
    for (kernel, m, n), k in at.items():
        rows.setdefault(f"{kernel} {m}x{n}", {})["launches"] = k
    print(json.dumps({"phase21": rows, "launches": launches, "card": card}))
    print(json.dumps({"steps": timings}))


if __name__ == "__main__":
    main()
