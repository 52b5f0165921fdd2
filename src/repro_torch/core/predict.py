"""Predictive execution-time model (paper Eq. 6).

The paper predicts kernel time as a linear function of the static
instruction mix, with coefficients equal to CPI (reciprocal throughput,
Table II):

    f(N) = c_f * O_fl + c_m * O_mem + c_b * O_ctrl + c_r * O_reg      (6)

On TPU the classes widen to the pipelines of the chip (MXU / VPU /
transcendental / HBM / VMEM / control), and we provide two composition
rules:

* ``mode='sum'`` — the paper-faithful Eq. 6 (all pipelines serialize).
* ``mode='max'`` — the roofline/overlap variant (pipelines overlap;
  time = slowest pipeline).  This is the beyond-paper refinement and is
  what the hillclimb optimizes against.

Coefficients are the reciprocal rates from
:func:`repro_torch.core.hw.tpu_rate_table`; `calibrate` refits them to
measured times (non-negative least squares, paper §VII).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.hw import (GpuSpec, HopperSpec, TpuSpec, cpi,
                                 require_tpu, resolve_target, tpu_rate_table)
from repro_torch.core.mix import InstructionMix

__all__ = [
    "CostModel", "default_tpu_model", "default_cuda_model",
    "default_hopper_model", "predict_time", "cuda_eq6_time",
    "calibrate", "spearman", "rank_candidates", "features_matrix",
    "static_times_batch",
]

_FEATURES = ("mxu_flops", "vpu_flops", "trans_flops", "hbm_bytes",
             "vmem_bytes", "ctrl_ops", "reg_ops")
_COMPUTE_COLS = (0, 1, 2)   # mxu, vpu, trans
_MEMORY_COLS = (3, 4)       # hbm, vmem
_CTRL_COLS = (5, 6)         # ctrl, reg


def features_matrix(mixes: Sequence[InstructionMix]) -> np.ndarray:
    """(N, 7) feature matrix in `_FEATURES` column order."""
    return np.array([[getattr(m, f) for f in _FEATURES] for m in mixes],
                    dtype=np.float64).reshape(len(mixes), len(_FEATURES))


@dataclasses.dataclass
class CostModel:
    """Linear-in-mix cost model: seconds = <coeffs, features(mix)>."""

    coeffs: Dict[str, float]
    mode: str = "sum"   # 'sum' (Eq. 6) | 'max' (roofline)
    name: str = "tpu-eq6"

    def features(self, mix: InstructionMix) -> np.ndarray:
        return np.array([getattr(mix, f) for f in _FEATURES], dtype=np.float64)

    def time(self, mix: InstructionMix) -> float:
        terms = [self.coeffs.get(f, 0.0) * getattr(mix, f) for f in _FEATURES]
        if self.mode == "max":
            # overlap compute pipes vs memory pipes vs control
            compute = (self.coeffs.get("mxu_flops", 0.0) * mix.mxu_flops
                       + self.coeffs.get("vpu_flops", 0.0) * mix.vpu_flops
                       + self.coeffs.get("trans_flops", 0.0) * mix.trans_flops)
            memory = (self.coeffs.get("hbm_bytes", 0.0) * mix.hbm_bytes
                      + self.coeffs.get("vmem_bytes", 0.0) * mix.vmem_bytes)
            ctrl = (self.coeffs.get("ctrl_ops", 0.0) * mix.ctrl_ops
                    + self.coeffs.get("reg_ops", 0.0) * mix.reg_ops)
            return float(max(compute, memory) + ctrl)
        return float(sum(terms))

    def coeff_vector(self) -> np.ndarray:
        return np.array([self.coeffs.get(f, 0.0) for f in _FEATURES],
                        dtype=np.float64)

    def fingerprint(self) -> str:
        """Content identity for tuning-cache keys: two models with the
        same name but different coefficients (e.g. successive
        `calibrate` fits) must not collide on one cache entry.

        Memoized per instance (this runs on every trace-time dispatch);
        mutating `coeffs` after the first call is unsupported — build a
        new CostModel instead, as `calibrate` does.
        """
        fp = self.__dict__.get("_fp")
        if fp is None:
            import hashlib
            import json
            payload = json.dumps(
                {"coeffs": {k: repr(v) for k, v in self.coeffs.items()},
                 "mode": self.mode}, sort_keys=True)
            digest = hashlib.sha256(payload.encode()).hexdigest()[:10]
            fp = self.__dict__["_fp"] = f"{self.name}@{digest}"
        return fp

    def time_batch(self, mixes: Optional[Sequence[InstructionMix]] = None,
                   F: Optional[np.ndarray] = None) -> np.ndarray:
        """Vectorized `time` over a whole candidate set — one NumPy pass.

        Accepts either a sequence of mixes or a precomputed ``F``
        feature matrix (``features_matrix`` column order).  This is the
        static-ranking hot path: scoring the full search space is a few
        matrix products instead of a Python loop over configurations.
        """
        if F is None:
            F = features_matrix(mixes or [])
        F = np.asarray(F, dtype=np.float64).reshape(-1, len(_FEATURES))
        T = F * self.coeff_vector()[None, :]      # per-pipeline seconds
        if self.mode == "max":
            compute = T[:, _COMPUTE_COLS].sum(axis=1)
            memory = T[:, _MEMORY_COLS].sum(axis=1)
            ctrl = T[:, _CTRL_COLS].sum(axis=1)
            return np.maximum(compute, memory) + ctrl
        return T.sum(axis=1)

    def breakdown(self, mix: InstructionMix) -> Dict[str, float]:
        return {f: self.coeffs.get(f, 0.0) * getattr(mix, f)
                for f in _FEATURES}


def default_tpu_model(spec: Optional[TpuSpec] = None,
                      mode: str = "sum") -> CostModel:
    rates = tpu_rate_table(require_tpu(spec, "default_tpu_model"))
    coeffs = {k: (1.0 / v if v else 0.0) for k, v in rates.items()
              if k in _FEATURES}
    # vmem traffic overlaps aggressively with compute; damp its serial cost
    coeffs["vmem_bytes"] = coeffs.get("vmem_bytes", 0.0)
    return CostModel(coeffs=coeffs, mode=mode,
                     name=f"tpu-eq6-{mode}")


def default_cuda_model(spec: Union[str, GpuSpec, None] = None) -> CostModel:
    """The paper's Eq. 6 as a `CostModel` (the GpuSpec counterpart of
    :func:`default_tpu_model`, used by registry dispatch).

    The four CUDA instruction classes ride the shared 7-feature layout
    under a fixed column mapping — O_fl -> ``mxu_flops``, O_mem ->
    ``hbm_bytes``, O_ctrl -> ``ctrl_ops``, O_reg -> ``reg_ops`` (the
    remaining TPU-only columns get zero weight) — so `time_batch` /
    `static_times_batch` / `rank_space` score CUDA candidate sets with
    the exact same vectorized pass TPU targets use.  Coefficients are
    CPI (reciprocal Table II throughput) over the class representatives
    of :func:`cuda_eq6_time`, divided by the core clock: seconds per
    event, paper-faithful serial composition (``mode='sum'``).
    """
    spec = resolve_target(spec)
    if not isinstance(spec, GpuSpec):
        raise TypeError(
            f"default_cuda_model needs a GpuSpec; got {spec.name!r} — "
            f"use default_tpu_model for TPU targets")
    hz = spec.gpu_clock_mhz * 1e6
    coeffs = {
        "mxu_flops": cpi("FPIns32", spec) / hz,   # O_fl
        "hbm_bytes": cpi("LdStIns", spec) / hz,   # O_mem
        "ctrl_ops": cpi("CtrlIns", spec) / hz,    # O_ctrl
        "reg_ops": cpi("Regs", spec) / hz,        # O_reg
    }
    return CostModel(coeffs=coeffs, mode="sum",
                     name=f"cuda-eq6-{spec.name}")


def default_hopper_model(spec: Union[str, HopperSpec, None] = None
                         ) -> CostModel:
    """Roofline pricing of one CUDA launch on a `HopperSpec` card.

    The port's kernels do their arithmetic on the bf16 tensor cores
    (``mxu_flops`` at ``bf16_tensor_flops``: the wgmma GEMM tiles) or
    on the FP32 CUDA cores (``vpu_flops`` at ``fp32_flops``), their
    exp/rsqrt on the special-function units (``trans_flops``), move
    ``hbm_bytes`` through device memory and ``vmem_bytes`` through
    shared memory; ``ctrl_ops`` counts launches.  Composition is
    ``mode='max'``: compute overlaps memory, launches serialize.  The
    kernel analyzers stretch this time by wave quantization over the
    SMs (`repro_torch.kernels.common.hopper_info_batch`)."""
    spec = resolve_target(spec)
    if not isinstance(spec, HopperSpec):
        raise TypeError(
            f"default_hopper_model needs a HopperSpec; got {spec.name!r}")
    coeffs = {
        "mxu_flops": 1.0 / spec.bf16_tensor_flops,
        "vpu_flops": 1.0 / spec.fp32_flops,
        "trans_flops": 1.0 / spec.sfu_rate,
        "hbm_bytes": 1.0 / spec.hbm_bw,
        "vmem_bytes": 1.0 / spec.smem_bw,
        "ctrl_ops": spec.launch_overhead_s,
        "reg_ops": 0.0,
    }
    return CostModel(coeffs=coeffs, mode="max",
                     name=f"hopper-roofline-{spec.name}")


def predict_time(mix: InstructionMix,
                 model: Optional[CostModel] = None) -> float:
    return (model or default_tpu_model()).time(mix)


def cuda_eq6_time(o_fl: float, o_mem: float, o_ctrl: float, o_reg: float,
                  gpu: GpuSpec) -> float:
    """The faithful Eq. 6 in units of cycles, CPI weights from Table II.

    Class CPIs use the paper's category representatives: FLOPS->FPIns32,
    MEM->LdStIns, CTRL->CtrlIns, REG->Regs.
    """
    return (cpi("FPIns32", gpu) * o_fl + cpi("LdStIns", gpu) * o_mem
            + cpi("CtrlIns", gpu) * o_ctrl + cpi("Regs", gpu) * o_reg)


# ---------------------------------------------------------------------------
# Calibration (NNLS on measured times) + rank metrics
# ---------------------------------------------------------------------------


def _nnls(A: np.ndarray, b: np.ndarray, iters: int = 3000,
          lr: Optional[float] = None) -> np.ndarray:
    """Tiny projected-gradient NNLS (no scipy needed)."""
    A = np.asarray(A, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    # column scaling for conditioning
    scale = np.maximum(np.abs(A).max(axis=0), 1e-30)
    As = A / scale
    x = np.maximum(np.linalg.lstsq(As, b, rcond=None)[0], 0.0)
    L = np.linalg.norm(As.T @ As, 2) + 1e-30
    step = (lr or 1.0 / L)
    for _ in range(iters):
        g = As.T @ (As @ x - b)
        x = np.maximum(x - step * g, 0.0)
    return x / scale


def calibrate(mixes: Sequence[InstructionMix],
              times_s: Sequence[float],
              base: Optional[CostModel] = None,
              mode: str = "sum") -> CostModel:
    """Fit non-negative Eq. 6 coefficients to measured times.

    Rows are weighted by 1/t (relative least squares): the tuner cares
    about rank order across variants that span decades of runtime, so
    minimizing relative rather than absolute residuals is the right
    objective.  Zero columns keep their base-model value so a kernel
    family that never exercises a pipeline does not zero it out.
    ``base`` defaults to `default_tpu_model`; pass `default_hopper_model`
    to fit the H100's coefficients.
    """
    base = base or default_tpu_model(mode=mode)
    A = np.stack([base.features(m) for m in mixes])
    b = np.asarray(times_s, dtype=np.float64)
    w = 1.0 / np.maximum(b, 1e-30)
    active = A.max(axis=0) > 0
    coeffs = dict(base.coeffs)
    if active.any():
        x = _nnls(A[:, active] * w[:, None], b * w)
        for f, v in zip(np.array(_FEATURES)[active], x):
            coeffs[str(f)] = float(v)
    return CostModel(coeffs=coeffs, mode=mode, name=base.name + "-calibrated")


def _avg_ranks(x: np.ndarray) -> np.ndarray:
    """Average (fractional) ranks: tied values share the mean of the
    ranks they span — the standard Spearman tie convention."""
    sx = np.sort(x)
    lo = np.searchsorted(sx, x, side="left")
    hi = np.searchsorted(sx, x, side="right")
    return (lo + hi - 1) / 2.0


def spearman(a: Sequence[float], b: Sequence[float]) -> float:
    """Spearman rank correlation (used for Fig. 5-style validation).

    Ties get average ranks.  Convention: a constant (zero-variance)
    vector carries no ranking information, so its correlation with
    anything — including another constant vector — is defined as 0.0
    rather than NaN; a flat predictor must score as uninformative, not
    poison downstream aggregation.
    """
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    ra = _avg_ranks(a)
    rb = _avg_ranks(b)
    ra -= ra.mean(); rb -= rb.mean()
    denom = np.sqrt((ra ** 2).sum() * (rb ** 2).sum())
    return float((ra * rb).sum() / denom) if denom else 0.0


def rank_candidates(mixes: Sequence[InstructionMix],
                    model: Optional[CostModel] = None
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Predicted times + ascending-rank order for a candidate set."""
    model = model or default_tpu_model()
    t = model.time_batch(mixes)
    return t, np.argsort(t, kind="stable")


def static_times_batch(infos: Optional[Sequence[object]],
                       model: CostModel,
                       *,
                       F: Optional[np.ndarray] = None,
                       pipe: Optional[np.ndarray] = None,
                       feasible: Optional[np.ndarray] = None) -> np.ndarray:
    """Vectorized `KernelStaticInfo.static_time` over a candidate set.

    Two input forms:

    * struct-of-arrays (the hot path): pass ``F`` — an (N, 7) feature
      matrix in `features_matrix` column order — plus optional ``pipe``
      (per-config pipeline floor, occupancy step time x grid steps) and
      ``feasible`` (bool mask) arrays, e.g. straight from
      `repro_torch.kernels.common.block_info_batch`.  No Python loop at all.
    * object sequence (compat): ``infos`` are KernelStaticInfo-like,
      with ``.mix``, ``.feasible()`` and optionally ``.occupancy``; the
      arrays above are gathered from them per config.

    Model scoring is a single batched pass either way; the pipeline
    floor and the +inf infeasibility penalty fold in element-wise.
    """
    if F is not None:
        t = np.asarray(model.time_batch(F=F), dtype=np.float64)
        if pipe is not None:
            t = np.maximum(t, np.asarray(pipe, dtype=np.float64))
        if feasible is not None:
            t = np.where(np.asarray(feasible, dtype=bool), t, np.inf)
        return t
    n = len(infos)
    if n == 0:
        return np.empty(0, dtype=np.float64)
    t = model.time_batch([i.mix for i in infos])
    pipe = np.zeros(n, dtype=np.float64)
    feas = np.ones(n, dtype=bool)
    for j, info in enumerate(infos):
        occ = getattr(info, "occupancy", None)
        if occ is not None:
            pipe[j] = occ.predicted_step_time * max(occ.grid_steps, 1)
        feas[j] = info.feasible()
    t = np.maximum(t, pipe)
    t[~feas] = np.inf
    return t
