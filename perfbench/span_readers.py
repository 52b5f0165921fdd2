"""The per-layer readers of the program's own spans
(`repro_torch.runtime.spans`): the traced stretch runs under the torch
profiler, which turns the program's spans on, and each reader takes its
number from the record's `summary()` once the stretch is over.  A
program without spans reads None, as does a record made off a CUDA
device for the numbers that need the card's events or its host time
(on the CPU a step's host span holds the CPU kernels themselves)."""
import statistics


def _summary():
    try:
        from repro_torch.runtime import spans
    except ImportError:
        return None
    return spans.summary()


def _device_ms(s, *names):
    ms = [s["spans"][n]["device_ms"] if n in s["spans"] else None
          for n in names]
    return None if None in ms else sum(ms)


def _share(part, whole):
    s = _summary()
    if s is None or s["device"] != "cuda":
        return None
    p, w = _device_ms(s, *part), _device_ms(s, whole)
    return 100.0 * p / w if p is not None and w else None


def attn_decode_share(run):
    """Device ms inside ``model.attention_decode`` over device ms inside
    ``serve.decode``."""
    return _share(("model.attention_decode",), "serve.decode")


def moe_shuffle_share(run):
    """Device ms inside the MoE layer's routing, dispatch and combine
    (``model.moe.route``, ``.dispatch``, ``.combine``) over device ms
    inside ``serve.prefill``."""
    return _share(("model.moe.route", "model.moe.dispatch",
                   "model.moe.combine"), "serve.prefill")


def host_step_ms(run):
    """The median host ms of a ``serve.decode`` span: the time the host
    takes to enqueue one decode step."""
    s = _summary()
    if s is None or s["device"] != "cuda" or "serve.decode" not in s["spans"]:
        return None
    return statistics.median(s["spans"]["serve.decode"]["host_ms_each"])


def dispatch_us(run):
    """The registry calls' dispatch time (entry to launch), in us a
    call."""
    s = _summary()
    if s is None or not s["dispatch"]["calls"]:
        return None
    return s["dispatch"]["ns"] / s["dispatch"]["calls"] / 1e3
