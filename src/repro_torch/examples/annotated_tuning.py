"""Orio-style annotated tuning (paper Fig. 3 workflow) on the H100.

    python -m repro_torch.examples.annotated_tuning [--device cpu]

Declare the tuning space as a PerfTuning annotation (the paper's
syntax), bind it to the CUDA GEMM, and let the H100 static analysis pick
the launch configuration without running anything.  The annotation
names the GEMM's compiled tile dimensions (rows, columns and depth of a
block's tile); a combination the library compiled is priced by the H100
analysis, one it did not is infeasible.  The static tune is the same on
any machine; ``--device`` only says where the picked kernel would run
(the CUDA card by default; without a card it raises unless ``--device
cpu`` is given).
"""
from __future__ import annotations

import argparse
import functools
import math

from repro_torch.core import H100_SXM, InstructionMix, KernelTuner, annotate
from repro_torch.kernels.api import HopperStaticInfo, TILE_AXIS, get_spec
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.matmul import (GEMM_TILES, SIMT, _matmul_inputs,
                                        matmul)

M = N = K = 1024

SPEC = """
/*@ begin PerfTuning (
 def performance_params {
 param bm[] = [16, 32, 64, 128];
 param bn[] = [16, 32, 64, 128];
 param bk[] = [16, 32, 64];
 }
) @*/
"""

# (bm, bn, bk) -> the compiled SIMT GEMM tile with those dimensions (the
# annotation's space is the SIMT block space)
TILE_OF = {fields[:3]: name for name, fields in GEMM_TILES.items()
           if fields[5] == SIMT}


def main(argv=None):
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device the picked kernel runs on (default: "
                    "the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    sig = dict(m=M, n=N, k=K, dtype="float32")
    spec = get_spec("matmul")

    def tile_of(p):
        return TILE_OF.get((p["bm"], p["bn"], p["bk"]))

    def static_info(p):
        tile = tile_of(p)
        if tile is None:            # not compiled: nothing to launch
            return HopperStaticInfo(mix=InstructionMix(),
                                    predicted_step_time=math.inf, ok=False)
        return spec.hopper_static_info({TILE_AXIS: tile}, H100_SXM, **sig)

    def make_inputs():
        gen = torch.Generator(device=device)
        gen.manual_seed(0)
        return _matmul_inputs(gen, **sig)

    kernel = annotate(
        "matmul_annotated", SPEC,
        build=lambda p: functools.partial(matmul, tile=tile_of(p)),
        static_info=static_info, make_inputs=make_inputs)
    compiled = sum(tile_of(p) is not None for p in kernel.space.enumerate())
    print(f"annotation parsed: {kernel.space.size} variants over axes "
          f"{list(kernel.space.axes)}, {compiled} of them compiled tiles")
    tuner = KernelTuner(kernel, spec=H100_SXM, repeats=2)
    rep = tuner.tune(mode="static")
    print(rep.summary())
    print(f"suggested launch: {rep.best_params} = tile "
          f"{tile_of(rep.best_params)} on {device} "
          f"(predicted {rep.best_predicted_s * 1e6:.1f} us, "
          f"{rep.empirical_evals} kernels executed)")
    assert rep.empirical_evals == 0
    return rep


if __name__ == "__main__":
    main()
