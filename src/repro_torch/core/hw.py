"""Hardware descriptors.

Two families live here:

1. The *faithful* reproduction of the paper's Table I (GPU hardware
   constants for Fermi M2050 / Kepler K20 / Maxwell M40) and Table II
   (instruction throughput in instructions-per-cycle per compute
   capability).  These feed the faithful CUDA occupancy equations
   (Eqs. 1-5) and the CPI weights of Eq. 6.

2. The TPU adaptation: chip-level specs for the supported TPU targets
   (v4 / v5e / v5p / v6e) and a throughput table playing the role of
   Table II for the TPU pipelines (MXU / VPU / transcendental / HBM /
   ICI).  ``TPU_TABLE`` is the Table-I analogue — one column per chip
   generation — and :func:`resolve_target` turns a name (or ``None``,
   meaning the process default from :mod:`repro_torch.core.target`) into a
   spec.

A third family, :class:`HopperSpec`, describes the H100 the PyTorch
port launches its CUDA kernels on.

All families satisfy the :class:`ChipSpec` protocol (a ``name`` plus
frozen-dataclass fields), which is all the tuning database, dispatch
registry, and cache-key fingerprint require — the static-tuning stack
is parametric over the *spec family*, not just the chip: a
``GpuSpec`` target routes dispatch through the faithful CUDA
occupancy/Eq. 6 models, a ``TpuSpec`` target through the Pallas
pipeline model (DESIGN.md §11).

Everything is a frozen dataclass so specs can be hashed into tuning
cache keys.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Protocol, Union, runtime_checkable


@runtime_checkable
class ChipSpec(Protocol):
    """What every hardware target must expose to the tuning stack.

    Satisfied structurally by both :class:`TpuSpec` and
    :class:`GpuSpec`: a stable ``name`` and frozen-dataclass fields
    (``dataclasses.asdict`` must work, so
    `repro_torch.tuning_cache.keys.fingerprint_spec` can content-address the
    descriptor).  Family-specific rates (VMEM budgets, warp slots)
    stay on the concrete classes — the shared stack never touches
    them; only the per-family occupancy/cost models do.
    """

    name: str


# ---------------------------------------------------------------------------
# Paper Table I -- GPU hardware constants (faithful).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GpuSpec:
    """One column of the paper's Table I.

    Naming follows the paper's symbols: superscript ``cc`` (compute
    capability provided) is dropped; subscripts become suffixes.
    """

    name: str
    family: str
    cc: float                     # compute capability
    multiprocessors: int          # mp
    cores_per_mp: int
    gpu_clock_mhz: float
    mem_clock_mhz: float
    global_mem_mb: int
    l2_cache_mb: float
    constant_mem_b: int
    shmem_per_block: int          # S_B^cc   (bytes)
    regs_per_block: int           # R_fs^cc  (register file size per MP)
    warp_size: int                # W_B
    threads_per_mp: int           # T_mp^cc
    threads_per_block: int        # T_B^cc
    blocks_per_mp: int            # B_mp^cc
    threads_per_warp: int         # T_W^cc
    warps_per_mp: int             # W_mp^cc
    reg_alloc_size: int           # R_B^cc   (register allocation granularity)
    regs_per_thread: int          # R_T^cc   (max registers per thread)

    @property
    def shmem_per_mp(self) -> int:
        """S_mp^cc — shared memory per SM (== per-block limit on these parts)."""
        return self.shmem_per_block


FERMI_M2050 = GpuSpec(
    name="m2050", family="Fermi", cc=2.0,
    multiprocessors=14, cores_per_mp=32, gpu_clock_mhz=1147.0,
    mem_clock_mhz=1546.0, global_mem_mb=3072, l2_cache_mb=0.786,
    constant_mem_b=65536, shmem_per_block=49152, regs_per_block=32768,
    warp_size=32, threads_per_mp=1536, threads_per_block=1024,
    blocks_per_mp=8, threads_per_warp=32, warps_per_mp=48,
    reg_alloc_size=64, regs_per_thread=63,
)

KEPLER_K20 = GpuSpec(
    name="k20", family="Kepler", cc=3.5,
    multiprocessors=13, cores_per_mp=192, gpu_clock_mhz=824.0,
    mem_clock_mhz=2505.0, global_mem_mb=11520, l2_cache_mb=1.572,
    constant_mem_b=65536, shmem_per_block=49152, regs_per_block=65536,
    warp_size=32, threads_per_mp=2048, threads_per_block=1024,
    blocks_per_mp=16, threads_per_warp=32, warps_per_mp=64,
    reg_alloc_size=256, regs_per_thread=255,
)

MAXWELL_M40 = GpuSpec(
    name="m40", family="Maxwell", cc=5.2,
    multiprocessors=24, cores_per_mp=128, gpu_clock_mhz=1140.0,
    mem_clock_mhz=5000.0, global_mem_mb=12288, l2_cache_mb=3.146,
    constant_mem_b=65536, shmem_per_block=49152, regs_per_block=65536,
    warp_size=32, threads_per_mp=2048, threads_per_block=1024,
    blocks_per_mp=32, threads_per_warp=32, warps_per_mp=64,
    reg_alloc_size=256, regs_per_thread=255,
)

GPU_TABLE: Dict[str, GpuSpec] = {
    "m2050": FERMI_M2050, "fermi": FERMI_M2050,
    "fermi-m2050": FERMI_M2050,
    "k20": KEPLER_K20, "kepler": KEPLER_K20,
    "kepler-k20": KEPLER_K20,
    "m40": MAXWELL_M40, "maxwell": MAXWELL_M40,
    "maxwell-m40": MAXWELL_M40,
}


# ---------------------------------------------------------------------------
# Paper Table II -- instruction throughput (IPC) per compute capability.
# ---------------------------------------------------------------------------

# category -> {sm20, sm35, sm52} instructions-per-cycle, faithful to Table II.
IPC_TABLE: Dict[str, Dict[str, int]] = {
    "FPIns32":     {"sm20": 32, "sm35": 192, "sm52": 128},
    "FPIns64":     {"sm20": 16, "sm35": 64,  "sm52": 4},
    "CompMinMax":  {"sm20": 32, "sm35": 160, "sm52": 64},
    "ShiftShuffle": {"sm20": 16, "sm35": 32, "sm52": 64},
    "Conv64":      {"sm20": 16, "sm35": 8,   "sm52": 4},
    "Conv32":      {"sm20": 16, "sm35": 128, "sm52": 32},
    "LogSinCos":   {"sm20": 4,  "sm35": 32,  "sm52": 32},
    "IntAdd32":    {"sm20": 32, "sm35": 160, "sm52": 64},
    "LdStIns":     {"sm20": 16, "sm35": 32,  "sm52": 64},   # Tex/LdSt/Surf
    "CtrlIns":     {"sm20": 16, "sm35": 32,  "sm52": 64},   # Pred/Ctrl
    "MoveIns":     {"sm20": 32, "sm35": 32,  "sm52": 32},
    "Regs":        {"sm20": 16, "sm35": 32,  "sm52": 32},
}

# Paper category -> coarse class used by Eq. 6 (O_fl, O_mem, O_ctrl, O_reg).
CATEGORY_CLASS: Dict[str, str] = {
    "FPIns32": "flops", "FPIns64": "flops", "CompMinMax": "flops",
    "ShiftShuffle": "flops", "Conv64": "flops", "Conv32": "flops",
    "LogSinCos": "flops", "IntAdd32": "flops",
    "LdStIns": "mem",
    "CtrlIns": "ctrl", "MoveIns": "ctrl",
    "Regs": "reg",
}


def sm_key(gpu: GpuSpec) -> str:
    return {2.0: "sm20", 3.5: "sm35", 5.2: "sm52"}[gpu.cc]


def cpi(category: str, gpu: GpuSpec) -> float:
    """Cycles-per-instruction = reciprocal of Table II IPC (paper §III-B)."""
    return 1.0 / float(IPC_TABLE[category][sm_key(gpu)])


# ---------------------------------------------------------------------------
# TPU adaptation -- the paper's Table I/II, one column per chip generation.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TpuSpec:
    """TPU chip + interconnect model used by occupancy/predict/roofline.

    One instance per supported chip generation (the Table-I analogue:
    the paper's Fermi/Kepler/Maxwell columns become v4/v5e/v5p/v6e).
    The three roofline constants (peak bf16 FLOP/s, HBM bandwidth, ICI
    link bandwidth) are public chip numbers; the VMEM/VPU numbers model
    the on-core memory hierarchy for the Pallas occupancy model.
    """

    name: str = "tpu-v5e"
    # Roofline constants (per chip).
    peak_flops_bf16: float = 197e12        # MXU, bf16
    peak_flops_f32: float = 49.25e12       # MXU f32 ~= bf16/4
    hbm_bw: float = 819e9                  # bytes/s
    ici_bw_per_link: float = 50e9          # bytes/s per link (uni)
    hbm_bytes: int = 16 * 1024**3          # 16 GiB
    # On-core hierarchy (Pallas model).
    vmem_bytes: int = 16 * 1024**2         # usable VMEM scratchpad budget / core (conservative)
    vmem_bw: float = 11e12                 # bytes/s VMEM<->VREG streaming (approx 8x128 lanes)
    vpu_flops: float = 3.2e12              # vector unit f32 FLOP/s (8x128 lanes x ~2 ALUs x clock)
    transcendental_flops: float = 0.4e12   # exp/log/tanh effective rate
    mxu_tile: tuple = (128, 128)           # systolic array facing dims
    sublane: int = 8                       # (8, 128) native vreg tile
    lane: int = 128
    cores_per_chip: int = 1                # v5e: 1 TensorCore per chip
    # Control overhead charged per grid step / scalar-unit op (seconds).
    ctrl_overhead_s: float = 120e-9
    # Inter-chip interconnect topology ('2d-torus' | '3d-torus').
    ici_topology: str = "2d-torus"

    @property
    def ici_links(self) -> int:
        """Links per chip, derived from the torus dimensionality:
        a d-dimensional torus has 2*d neighbours (2D -> 4, 3D -> 6)."""
        return {"2d-torus": 4, "3d-torus": 6}[self.ici_topology]


TPU_V5E = TpuSpec()

TPU_V4 = TpuSpec(
    name="tpu-v4",
    peak_flops_bf16=275e12, peak_flops_f32=68.75e12,
    hbm_bw=1228e9, ici_bw_per_link=50e9,
    hbm_bytes=32 * 1024**3,
    vmem_bytes=16 * 1024**2, vmem_bw=15e12,
    vpu_flops=4.4e12, transcendental_flops=0.55e12,
    cores_per_chip=2, ctrl_overhead_s=140e-9,
    ici_topology="3d-torus",
)

TPU_V5P = TpuSpec(
    name="tpu-v5p",
    peak_flops_bf16=459e12, peak_flops_f32=114.75e12,
    hbm_bw=2765e9, ici_bw_per_link=100e9,
    hbm_bytes=95 * 1024**3,
    vmem_bytes=32 * 1024**2, vmem_bw=22e12,
    vpu_flops=7.4e12, transcendental_flops=0.9e12,
    cores_per_chip=2, ctrl_overhead_s=110e-9,
    ici_topology="3d-torus",
)

TPU_V6E = TpuSpec(
    name="tpu-v6e",
    peak_flops_bf16=918e12, peak_flops_f32=229.5e12,
    hbm_bw=1640e9, ici_bw_per_link=100e9,
    hbm_bytes=32 * 1024**3,
    vmem_bytes=32 * 1024**2, vmem_bw=25e12,
    vpu_flops=14.2e12, transcendental_flops=1.8e12,
    cores_per_chip=1, ctrl_overhead_s=100e-9,
    ici_topology="2d-torus",
)

# The Table-I analogue for the TPU side: canonical name -> spec, plus
# short aliases.  Shipped pretuned databases exist for the entries of
# `repro_torch.tuning_cache.cli.SHIPPED_TARGETS` (a subset of this table).
TPU_TABLE: Dict[str, TpuSpec] = {
    "tpu-v4": TPU_V4, "v4": TPU_V4,
    "tpu-v5e": TPU_V5E, "v5e": TPU_V5E,
    "tpu-v5p": TPU_V5P, "v5p": TPU_V5P,
    "tpu-v6e": TPU_V6E, "v6e": TPU_V6E,
}

# ---------------------------------------------------------------------------
# Hopper -- the card the port launches on.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HopperSpec:
    """NVIDIA Hopper target whose ranked space is the CUDA kernels' own
    launch space (tile shape, threads, variant), not an analysis-only
    ``{"threads": ...}`` lattice.

    The Eqs. 1-5 fields carry the same names as :class:`GpuSpec`, so
    `repro_torch.core.occupancy.cuda_occupancy` / `_batch` run on it
    unchanged; unlike the Table I parts, the per-SM shared memory
    (``shmem_per_mp``) differs from the per-block opt-in limit, and the
    roofline rates price a launch for the H100 cost model
    (`repro_torch.core.predict.default_hopper_model`).
    """

    name: str = "h100-sxm"
    family: str = "Hopper"
    cc: float = 9.0                       # compute capability 9.0 (sm_90)
    # NVIDIA H100 Tensor Core GPU datasheet (SXM5 column) + Hopper
    # architecture white paper, unless noted.
    multiprocessors: int = 132            # SMs on the SXM5 part
    cores_per_mp: int = 128               # FP32 cores per SM (white paper)
    gpu_clock_mhz: float = 1980.0         # boost: 132*128*2*1.98 GHz = 67 TF
    fp32_flops: float = 67e12             # FP32 (CUDA cores), datasheet
    bf16_tensor_flops: float = 989e12     # BF16 tensor core, dense, datasheet
    hbm_bw: float = 3.35e12               # HBM3 bytes/s, datasheet
    hbm_bytes: int = 80 * 10**9           # 80 GB HBM3, datasheet
    l2_bytes: int = 50 * 1024**2          # 50 MB L2, white paper
    # CUDA C++ Programming Guide, "Compute Capabilities" table (cc 9.0):
    shmem_per_block: int = 232448         # S_B: 227 KB per block (opt-in)
    shmem_per_mp: int = 233472            # S_mp: 228 KB per SM
    shmem_reserved_per_block: int = 1024  # driver-reserved smem per block
    regs_per_block: int = 65536           # R_fs: 64K 32-bit registers / SM
    warp_size: int = 32                   # W_B
    threads_per_mp: int = 2048            # T_mp
    threads_per_block: int = 1024         # T_B
    blocks_per_mp: int = 32               # B_mp
    threads_per_warp: int = 32            # T_W
    warps_per_mp: int = 64                # W_mp
    reg_alloc_size: int = 256             # R_B: per-warp allocation unit
    regs_per_thread: int = 255            # R_T
    # Programming Guide, "Arithmetic Instructions" throughput table:
    # 16 MUFU results (exp2/rsqrt/...) per clock per SM on cc 9.0.
    sfu_rate: float = 16 * 132 * 1980e6
    # Programming Guide, "Shared Memory": 32 banks x 4 bytes per clock.
    smem_bw: float = 128 * 132 * 1980e6
    # Host launch + grid setup per kernel launch.  Not a datasheet
    # number: the few-microsecond order the CUDA Best Practices Guide
    # gives for launch latency; it only separates one-launch from
    # multi-launch variants.
    launch_overhead_s: float = 4e-6
    # Warps an SM must hold to keep enough loads in flight to reach its
    # share of the HBM rate.  A model assumption derived by Little's
    # law, not a datasheet number: 3.35 TB/s / 132 SMs x ~600 ns of
    # DRAM latency is ~15 KB in flight per SM; a warp of these scalar-
    # load kernels keeps ~512 B in flight, so ~32 warps (half of W_mp).
    latency_warps: int = 32
    # Bytes an SM must keep in flight, for kernels that state their
    # bytes in flight per block (16-byte vector loads with several rows
    # outstanding, TMA stage rings) and so can draw more than their
    # SM's share of the HBM rate.  Little's law at the loaded latency:
    # 3.35 TB/s / 132 SMs x ~2.5 us.  A fit, not a datasheet number: the
    # TMA GEMM tiles at M = 4 (chip_smoke.py [ranking]) drew 0.9-2.6 TB/s
    # from 1.5-8 MB in flight, i.e. 1.3-3 us of latency under load.
    latency_bytes: int = 64 * 1024
    # bf16 FLOP/s one warp's own stream of mma.sync m16n8k16 reaches,
    # with its ldmatrix operands and the dependences between them: the
    # tensor-core flash tiles are bound by their slowest warp's chain of
    # MMAs at the serve shapes, not by the card's tensor rate.  A fit,
    # not a datasheet number: the device time per launch of the best
    # tensor-core flash row of each warp split in chip_smoke.py's
    # [ranking] at 4 x 16 x 64 x 256 causal (one run on an H100 SXM at
    # 700 W: chains of 1.573, 1.049 and 0.786 MFLOP a warp in 16.97,
    # 11.77 and 9.93 us), less launch_overhead_s, which the model adds
    # on top; the least-squares line through the origin is 7.92 us per
    # MFLOP (residuals +0.51, -0.54, -0.30 us), about one MMA every 64
    # cycles at 1.98 GHz.
    mma_warp_flops: float = 1.26e11


H100_SXM = HopperSpec()

HOPPER_TABLE: Dict[str, HopperSpec] = {
    "h100-sxm": H100_SXM, "h100": H100_SXM, "hopper": H100_SXM,
    "hopper-h100": H100_SXM,
}


_default_target = None   # repro_torch.core.target.default_target, bound on use


def resolve_target(target: Optional[Union[str, "ChipSpec"]] = None
                   ) -> "ChipSpec":
    """Name-or-spec -> spec; ``None`` -> the process default target.

    One resolver for *both* spec families.  Accepts canonical TPU names
    ('tpu-v5p'), short aliases ('v5p'), the spellings jax's
    ``device_kind`` / env vars use ('TPU v5p', 'tpu_v5p',
    'TPU v5 lite'), and the paper's Table I GPUs by part, family, or
    family_part composite ('k20', 'kepler', 'kepler_k20',
    'fermi-m2050', 'maxwell_m40'), and the H100 by table name ('h100',
    'h100-sxm') or by any CUDA device name containing 'H100' (what
    ``torch.cuda.get_device_name`` reports, e.g. 'NVIDIA H100 80GB
    HBM3').  A `TpuSpec`, `GpuSpec` or `HopperSpec` passes through
    unchanged so every ``spec=`` keyword in the stack takes any form.
    """
    if target is None:
        # lazily bound: hw <- target is the import direction, and this
        # runs on every spec=None warm dispatch — a per-call
        # `from ... import` costs an importlib round trip each time
        global _default_target
        if _default_target is None:
            from repro_torch.core.target import default_target
            _default_target = default_target
        return _default_target()
    if isinstance(target, (TpuSpec, GpuSpec, HopperSpec)):
        return target
    name = str(target).strip().lower().replace("_", "-").replace(" ", "-")
    # device_kind spellings: 'TPU v5 lite' / 'TPU v6 lite' are the
    # efficiency chips; bare 'TPU v5' is how jax reports v5p.
    name = name.replace("v5-lite", "v5e").replace("v6-lite", "v6e")
    if name in ("tpu-v5", "v5"):
        name = "tpu-v5p"
    for key in (name, name[len("tpu-"):] if name.startswith("tpu-") else name):
        if key in TPU_TABLE:
            return TPU_TABLE[key]
    if name in GPU_TABLE:
        return GPU_TABLE[name]
    if name in HOPPER_TABLE:
        return HOPPER_TABLE[name]
    if "h100" in name:
        return H100_SXM
    raise KeyError(
        f"unknown hardware target {target!r}; known TPUs: "
        f"{sorted(k for k in TPU_TABLE if k.startswith('tpu-'))}, "
        f"GPUs: {sorted(k for k in GPU_TABLE if '-' in k)}, "
        f"Hopper: {sorted(HOPPER_TABLE)}")


def isa_family(spec: Optional[Union[str, "ChipSpec"]] = None) -> str:
    """Stable ISA-family key for the per-family instruction tables
    (`repro_torch.core.isa`): GPU specs (the Table I parts and the H100)
    group by SASS generation (their ``family`` — one latency profile per
    architecture, many parts), TPU specs are one pipeline family per
    generation (their canonical name).  Resolves names/None like
    `resolve_target`."""
    spec = resolve_target(spec)
    if isinstance(spec, (GpuSpec, HopperSpec)):
        return spec.family
    return spec.name


def require_tpu(spec: "ChipSpec", what: str) -> TpuSpec:
    """Resolve + family-check for the TPU-only layers.

    The Pallas pipeline model reads TPU-only fields (VMEM budget, MXU
    rates); handing it a `GpuSpec` must fail with a pointer to the
    CUDA-side model, not an AttributeError three frames down.
    """
    spec = resolve_target(spec)
    if not isinstance(spec, TpuSpec):
        raise TypeError(
            f"{what} models the TPU pipeline and needs a TpuSpec; got the "
            f"CUDA target {spec.name!r} — use the cuda_* analogue "
            f"(repro_torch.core.occupancy.cuda_occupancy / "
            f"repro_torch.core.predict.default_cuda_model) for GpuSpec "
            f"targets")
    return spec


# Instruction-class peak rates for Eq. 6 on TPU (the Table II analogue).
# Keys are the InstructionMix categories defined in repro_torch.core.mix.
def tpu_rate_table(spec: Optional[TpuSpec] = None) -> Dict[str, float]:
    spec = require_tpu(spec, "tpu_rate_table")
    return {
        # FLOP-like categories: events/sec.
        "mxu_flops": spec.peak_flops_bf16,
        "vpu_flops": spec.vpu_flops,
        "trans_flops": spec.transcendental_flops,
        # byte categories: bytes/sec.
        "hbm_bytes": spec.hbm_bw,
        "vmem_bytes": spec.vmem_bw,
        # control / bookkeeping: events/sec (reciprocal of per-event cost).
        "ctrl_ops": 1.0 / spec.ctrl_overhead_s,
        "reg_ops": spec.vpu_flops,  # move/copy at vector-lane rate
    }


# dtype -> bytes (used all over the analyzers).
DTYPE_BYTES: Dict[str, int] = {
    "bool": 1, "int8": 1, "uint8": 1, "float8_e4m3fn": 1, "float8_e5m2": 1,
    "int16": 2, "uint16": 2, "bfloat16": 2, "float16": 2,
    "int32": 4, "uint32": 4, "float32": 4,
    "int64": 8, "uint64": 8, "float64": 8, "complex64": 8,
    "complex128": 16,
}


def dtype_bytes(dtype) -> int:
    name = getattr(dtype, "name", None)
    if name is None:
        # scalar-type classes like jnp.bfloat16 have no .name; normalize
        # through np.dtype so bf16 is not silently billed as 4 bytes
        try:
            import numpy as np
            name = np.dtype(dtype).name
        except TypeError:
            name = str(dtype)
    return DTYPE_BYTES.get(str(name), 4)
