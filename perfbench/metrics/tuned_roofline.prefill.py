"""`perfbench.readers.tuned_roofline`, in the prefill cells."""
from perfbench.readers import tuned_roofline as read  # noqa: F401
