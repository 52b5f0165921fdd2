"""`perfbench.span_readers.host_step_ms`, in the decode cells."""
from perfbench.span_readers import host_step_ms as read  # noqa: F401
