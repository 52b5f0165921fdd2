"""`perfbench.span_readers.moe_shuffle_share`, in the prefill cells."""
from perfbench.span_readers import moe_shuffle_share as read  # noqa: F401
