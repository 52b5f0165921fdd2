"""`perfbench.readers.plain_share`, in the decode cells."""
from perfbench.readers import plain_share as read  # noqa: F401
