"""chip_smoke's build and Table IV phase (`phase_table4`), then its
one-card [mesh] (a) case for one arch (default qwen2-moe-a2.7b), all
from the checkout at ROOT (default: this one), in one process: the
one-card wall and host ratios of the meshed step after the earlier
phase that runs the most kernels.  Run it for two checkouts in one
call, alternating (A, B, B, A), to compare their readings:

    python3 tools/mesh_after_table4.py [ROOT] [--arch ARCH]

A gate of the mesh case that fails is reported, not raised, so that
every run of a sequence is read.  Before and after the Table IV phase
it prints what the process does while idle (CPU seconds over 5 s, its
threads) and the card's SM clock, temperature and power draw.
"""
import argparse
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def idle(when: str, seconds: float = 5.0) -> None:
    """What this process does while it waits: CPU seconds over an idle
    window, its threads, and the card's SM clock, temperature and
    power draw."""
    import subprocess
    import time
    c0 = time.process_time()
    time.sleep(seconds)
    cpu = time.process_time() - c0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,temperature.gpu,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"[pair] idle {seconds:g} s {when}: {cpu:.3f} CPU s, "
          f"{len(os.listdir('/proc/self/task'))} threads; card "
          f"{card.strip()}", flush=True)


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("root", nargs="?", default=HERE)
    ap.add_argument("--arch", default="qwen2-moe-a2.7b",
                    choices=("qwen2-moe-a2.7b", "gemma-7b"))
    args = ap.parse_args(argv)
    arch, root = args.arch, os.path.abspath(args.root)
    sys.path[:0] = [os.path.join(root, "src"), root]
    import torch
    import chip_smoke as cs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = cs.card_line()
    print(f"[pair] checkout {root}: {cs.__file__}", flush=True)
    cs.phase_build()
    idle("after the build")
    cs.phase_table4(dev)
    idle("after the Table IV phase")
    from repro_torch.kernels import _cuda
    _cuda.library()
    layers, of = {"qwen2-moe-a2.7b": (cs.MOE_LAYERS, 24),
                  "gemma-7b": (cs.TRAIN_LAYERS, 28)}[arch]
    try:
        cs._mesh_case(arch, layers, of, (1, 1), card)
        print(f"[pair] {root} {arch}: every gate passed", flush=True)
    except SystemExit as e:
        print(f"[pair] {root} {arch}: a gate failed (exit {e.code})",
              flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
