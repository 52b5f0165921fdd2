"""Process start to the window's first request: imports, the kernel
library's load (its build, on a checkout's first run), the weights,
pretune and freeze, warm-up, and the traffic's own set-up."""


def read(run):
    return run.setup_s
