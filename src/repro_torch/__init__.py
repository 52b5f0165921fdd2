"""repro_torch — the PyTorch/CUDA port of the static-analysis autotuner.

Mirrors the layout of the JAX reference package: `core` (Eqs. 1-6, the
hardware targets), `tuning_cache` (keys, database, dispatch registry),
`kernels` (the `@tuned_kernel` declarations, each with a hand-written
CUDA kernel for the H100 and a plain PyTorch version), `models` and
`launch` (the dense LM serving path).  Entry points run on the CUDA
card unless the caller asks for the CPU.
"""
