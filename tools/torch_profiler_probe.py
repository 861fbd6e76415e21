"""Does a ``train.profile_trace`` window change what later torch.profiler
windows keep? (card)

chip_smoke's kernel timings take each kernel's device time from a
torch.profiler trace and retake a window that kept fewer than half of its
launches. This probe times ``cell_kuf`` at (64, 16 384) in three windows
(``chip_smoke.time_ms``, printing how many launches each kept), then, in
the same process, runs one profiled training step of a collapsed model
through the trace context named by ``--variant``, and times the kernel
again:

- ``none``: no trace between the timings;
- ``handler``: ``train.profile_trace`` (``torch.profiler.profile`` with
  ``tensorboard_trace_handler``);
- ``export``: ``torch.profiler.profile`` and ``export_chrome_trace``;
- ``many``: no trace, but 500 000 small kernel launches (phase 15 makes
  millions before the timings);
- ``memory``: no trace, but the caching allocator left holding
  ``--hold-gb`` of freed blocks (phase 15's full-width Hessians hold tens
  of GB), then the windows again after ``torch.cuda.empty_cache()``.

    python3 tools/torch_profiler_probe.py --variant handler

Run each variant in its own process (a profiler's state lasts as long as
the process).
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", choices=("none", "handler", "export", "many", "memory"),
                    default="handler")
    ap.add_argument("--hold-gb", type=float, default=70.0)
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from vggp_tpu_torch import CellIntegralFeature, SGPRSpec, sgpr, train
    from vggp_tpu_torch.ops import _build
    from vggp_tpu_torch.ops import cell_kuf as ck

    device = torch.device("cuda")
    print(cs.card_line())
    _build.load()
    mesh, x, v, ell, _ = cs.kernel_inputs(64, 16384, torch.float32, device, seed=7)
    kern = lambda: ck.cell_kuf(mesh, x, v, ell)

    def windows(tag):
        for _ in range(3):
            prof, _ = cs._profiled(kern, 20)
            kept = len(cs._device_events(prof, cs._DEVICE_KERNELS["cell_kuf"]))
            print(f"{args.variant} {tag}: a window of 20 launches kept {kept} "
                  f"({len(cs._device_events(prof))} device records)")

    windows("before")
    spec = SGPRSpec(kinds=("matern12",) * 2,
                    features=tuple(CellIntegralFeature.from_lims(64, 0.0, 1.0) for _ in range(2)))
    X = torch.rand((8192, 2), device=device)
    y = torch.sin(6 * X[:, 0])
    params = train.non_informative_init(spec.init_params(torch.float32), X, y)
    raw = train.raw_leaves_from(params)
    step = train.make_step_fn(lambda p: sgpr.loss(spec, p, X, y), raw,
                              torch.optim.Adam(train.tree_leaves(raw), lr=1e-2))
    with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(__file__))) as d:
        if args.variant == "handler":
            with train.profile_trace(d):
                step()
        elif args.variant == "export":
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                step()
            prof.export_chrome_trace(os.path.join(d, "trace.json"))
        elif args.variant == "memory":
            blocks = [torch.empty(2 ** 30, dtype=torch.uint8, device=device)
                      for _ in range(int(args.hold_gb))]
            print(f"memory: reserved {torch.cuda.memory_reserved() / 2 ** 30:.1f} GiB")
            del blocks
        elif args.variant == "many":
            t = torch.zeros(8, device=device)
            for _ in range(500_000):
                t = t + 1.0
        else:
            step()
        torch.cuda.synchronize()
        print(f"{args.variant}: trace files {sorted(os.listdir(d))}")
    windows("after")
    if args.variant == "memory":
        torch.cuda.empty_cache()
        windows("after empty_cache")
    return 0


if __name__ == "__main__":
    sys.exit(main())
