"""Seconds from the process's start to the window's first step or request."""


def read(rec):
    return rec["setup_s"]
