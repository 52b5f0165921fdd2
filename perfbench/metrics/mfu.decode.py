"""The window's decode steps' least time (per step the larger of its
operations at the bf16 peak and its bytes at the memory's rate:
`perfbench.work.decode_flops`, `decode_bytes`), over the window's
seconds."""
from perfbench.work import decode_bytes, decode_flops, least_s


def read(run):
    t = sum(least_s(decode_flops(run.m, b, s), decode_bytes(run.m, b, s),
                    run.m["dtype"])
            for kind, b, s in run.window["work"] if kind == "decode")
    return 100.0 * t / run.window["window_s"] if t else None
