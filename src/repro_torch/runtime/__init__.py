"""The training supervisor (`fault`) and the serving path's spans
(`spans`).  The supervisor's names load on first use: the kernel
registry and the models import `spans`, and `fault` imports them."""
_FAULT = ("FaultPolicy", "FaultSchedule", "StragglerDetected",
          "TrainSupervisor", "scheduled_fault")


def __getattr__(name):
    if name in _FAULT:
        from repro_torch.runtime import fault
        return getattr(fault, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
