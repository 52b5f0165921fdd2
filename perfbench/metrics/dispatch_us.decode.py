"""`perfbench.span_readers.dispatch_us`, in the decode cells."""
from perfbench.span_readers import dispatch_us as read  # noqa: F401
