"""`perfbench.readers.frozen_share`, in the decode cells."""
from perfbench.readers import frozen_share as read  # noqa: F401
