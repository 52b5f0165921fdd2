"""The window's prefill work (`perfbench.work.prefill_flops`: every
layer at every prompt position, the head at the last) over the window's
seconds at the chip's bf16 peak."""
from perfbench.work import PEAK_FLOPS, prefill_flops


def read(run):
    flops = sum(prefill_flops(run.m, b, n)
                for kind, b, n in run.window["work"] if kind == "prefill")
    return (100.0 * flops / (run.window["window_s"] * PEAK_FLOPS[run.m["dtype"]])
            if flops else None)
