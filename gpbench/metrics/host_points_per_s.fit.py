"""Training points of every step in the timed window over the window's
seconds: the pace that the host's dispatch sets, reported per layer."""


def read(rec):
    return rec["points"] / rec["window_s"] if rec.get("kind") == "fit" else None
