"""`perfbench.readers.idle_share`, in the prefill cells."""
from perfbench.readers import idle_share as read  # noqa: F401
