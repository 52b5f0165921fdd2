"""`perfbench.span_readers.attn_decode_share`, in the decode cells."""
from perfbench.span_readers import attn_decode_share as read  # noqa: F401
