#!/usr/bin/env python3
"""Run one cell of the benchmark of ``vggp_tpu_torch`` once.

    python3 gpbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA devices the cell
asks for. The last line of standard output is the result's JSON object;
the last lines of standard error are the numbers compared, each beside its
limit. Without the devices it exits 2 and prints no result.
"""

import time

_T_IMPORT = time.perf_counter()


def _process_start() -> float:
    """The process's start on the ``perf_counter`` clock: its start time in
    ``/proc/self/stat`` against ``/proc/uptime`` (10 ms steps), or this
    file's first line where those cannot be read."""
    import os

    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        since = uptime - ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return _T_IMPORT
    return time.perf_counter() - max(since, 0.0)


if __name__ == "__main__":
    import sys
    from pathlib import Path

    t_start = _process_start()
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from gpbench.harness import main

    sys.exit(main(sys.argv[1:], t_start))
