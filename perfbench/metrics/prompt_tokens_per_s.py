"""Prompt tokens of the requests the window completed, over its seconds."""


def read(run):
    n = sum(r["prompt"] for r in run.window["requests"])
    return n / run.window["window_s"] if n else None
