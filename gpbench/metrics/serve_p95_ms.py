"""The 95th percentile of the latency of every request in the window, ms."""

import statistics


def read(rec):
    if rec.get("kind") != "serve" or len(rec["latencies_s"]) < 2:
        return None
    return 1e3 * statistics.quantiles(rec["latencies_s"], n=100, method="inclusive")[94]
