"""The per-layer readers that a prefill and a decode metric share; each
``metrics/<name>.py`` takes its ``read`` from here."""


def frozen_share(run):
    """Registry dispatches of the window served from the frozen tables,
    as a share of all of them (`repro_torch.kernels.api.dispatch_stats`)."""
    d = run.dispatch
    return 100.0 * d["frozen"] / d["total"] if d and d["total"] else None


def plain_share(run):
    """The share of the traced stretch's device time spent outside the
    registry ops' spans: the plain PyTorch around the tuned kernels."""
    p = run.profile
    if not p or not p["kernel_s"]:
        return None
    inside = sum(p["span_kernel_s"].values())
    return 100.0 * max(p["kernel_s"] - inside, 0.0) / p["kernel_s"]


def tuned_roofline(run):
    """The registry calls' least time (`perfbench.work.op_work`, from each
    call's shapes), summed, over the device time of the kernels launched
    inside those calls' spans; ops the yardstick does not count are left
    out of both."""
    p = run.profile
    if not p:
        return None
    least = sum(p["least_s"].values())
    spent = sum(v for k, v in p["span_kernel_s"].items()
                if k in p["least_s"])
    return 100.0 * least / spent if spent > 0 and least > 0 else None


def idle_share(run):
    """1 - the union of the traced stretch's device-busy intervals over
    its wall time."""
    p = run.profile
    if not p or not p["busy_s"]:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["wall_s"])
