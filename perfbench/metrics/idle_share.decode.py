"""`perfbench.readers.idle_share`, in the decode cells."""
from perfbench.readers import idle_share as read  # noqa: F401
