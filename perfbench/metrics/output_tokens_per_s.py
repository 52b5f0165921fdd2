"""Tokens generated in the window, over its seconds."""


def read(run):
    n = sum(r["output"] for r in run.window["requests"])
    return n / run.window["window_s"] if n else None
