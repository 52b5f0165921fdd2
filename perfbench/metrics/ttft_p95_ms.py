"""95th percentile, over every request of the window, of the time from
when its batch was due to when its first token was on the host."""
import numpy as np


def read(run):
    t = [r["ttft_s"] for r in run.window["requests"] if "ttft_s" in r]
    return float(np.percentile(t, 95)) * 1e3 if t else None
