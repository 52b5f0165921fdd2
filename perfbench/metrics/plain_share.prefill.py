"""`perfbench.readers.plain_share`, in the prefill cells."""
from perfbench.readers import plain_share as read  # noqa: F401
