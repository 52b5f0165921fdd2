"""repro_torch.core — static & predictive autotuning, ported.

Layers (paper §III):
  hw         Table I / Table II constants, TPU targets, the H100 target
  target     process-default hardware target (env / autodetect / scoped)
  mix        the instruction-mix record Eq. 6 prices
  occupancy  CUDA Eqs. 1-5 (faithful) + TPU pipeline occupancy
  predict    Eq. 6 time model, the H100 roofline model, rank metrics
  search     SearchSpace: named axes, constraints, streamed lattices
  autotuner  KernelStaticInfo + GraphTuner.tune_config
"""
from repro_torch.core.hw import (GPU_TABLE, FERMI_M2050, KEPLER_K20,
                                 MAXWELL_M40, H100_SXM, HOPPER_TABLE,
                                 ChipSpec, GpuSpec, HopperSpec, TpuSpec,
                                 TPU_V4, TPU_V5E, TPU_V5P, TPU_V6E,
                                 TPU_TABLE, resolve_target, require_tpu,
                                 IPC_TABLE, cpi, tpu_rate_table,
                                 dtype_bytes)
from repro_torch.core.target import (ENV_TARGET, default_target,
                                     set_default_target, use_target,
                                     detect_target)
from repro_torch.core.mix import InstructionMix, intensity
from repro_torch.core.occupancy import (CudaOccupancy, cuda_occupancy,
                                        CudaOccupancyBatch,
                                        cuda_occupancy_batch,
                                        suggest_cuda_params, TpuOccupancy,
                                        tpu_occupancy, suggest_block_shapes)
from repro_torch.core.predict import (CostModel, default_tpu_model,
                                      default_cuda_model,
                                      default_hopper_model, cuda_eq6_time,
                                      spearman, features_matrix,
                                      static_times_batch)
from repro_torch.core.search import (SearchSpace, ConfigLattice, Constraint,
                                     DEFAULT_CHUNK)
from repro_torch.core.autotuner import KernelStaticInfo, GraphTuner
