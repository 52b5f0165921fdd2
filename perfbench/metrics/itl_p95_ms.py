"""95th percentile, over the window, of the gaps between a sequence's
consecutive output tokens (the steps' end events on the card)."""
import numpy as np


def read(run):
    g = run.window.get("itl_ms")
    return float(np.percentile(g, 95)) if g else None
