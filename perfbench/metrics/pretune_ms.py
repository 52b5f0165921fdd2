"""Host time of the set-up's graph pretune of every shape the traffic
sends, with the thaw and freeze after it (the static tuning layer)."""


def read(run):
    return run.pretune_s * 1e3
