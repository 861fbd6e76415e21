"""Query points answered in the window over the window's seconds."""


def read(rec):
    return rec["points"] / rec["window_s"] if rec.get("kind") == "serve" else None
