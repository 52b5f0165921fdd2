"""repro_torch.core — static & predictive autotuning, ported.

Layers (paper §III):
  hw         Table I / Table II constants, TPU targets, the H100 target
  target     process-default hardware target (env / autodetect / scoped)
  mix        instruction-mix extraction (torch graph + HLO text) and the
             record Eq. 6 prices, boundedness rule
  occupancy  CUDA Eqs. 1-5 (faithful) + TPU pipeline occupancy
  predict    Eq. 6 time model, the H100 roofline model, calibration,
             rank metrics
  search     exhaustive/random/SA/genetic/Nelder-Mead/static-pruned
  autotuner  KernelTuner (TPU block spaces, H100 tile tables) +
             GraphTuner.tune_config
  annotations  the Orio PerfTuning front end (paper Fig. 3)
  hlo        collective bytes, op census, remat-duplication (HLO text)
  roofline   3-term roofline from compiled artifacts (TPU and H100)
  sass       the census of the port's own sm_90a binaries
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
from repro_torch.core.mix import (InstructionMix, TorchGraph, trace_fn,
                                 mix_from_graph, mix_of_fn,
                                 mix_from_hlo_text, mix_from_cost_analysis,
                                 intensity, classify_boundedness)
from repro_torch.core.occupancy import (CudaOccupancy, cuda_occupancy,
                                        CudaOccupancyBatch,
                                        cuda_occupancy_batch,
                                        suggest_cuda_params, TpuOccupancy,
                                        tpu_occupancy, suggest_block_shapes)
from repro_torch.core.predict import (CostModel, default_tpu_model,
                                      default_cuda_model,
                                      default_hopper_model, predict_time,
                                      cuda_eq6_time, calibrate, spearman,
                                      rank_candidates, features_matrix,
                                      static_times_batch)
from repro_torch.core.search import (SearchSpace, SearchResult,
                                     ConfigLattice, Constraint, DEFAULT_CHUNK,
                                     ExhaustiveSearch, RandomSearch,
                                     SimulatedAnnealing, GeneticSearch,
                                     NelderMeadSearch, StaticPrunedSearch)
from repro_torch.core.autotuner import (KernelStaticInfo, TunableKernel,
                                        TuningReport, KernelTuner,
                                        GraphTuner, make_intensity_rule)
from repro_torch.core.annotations import annotate, parse_tuning_spec
from repro_torch.core.hlo import (collective_stats, op_census,
                                 remat_duplication, analyze_hlo, HloReport,
                                 CollectiveStats, parse_hlo, module_mix,
                                 HloModule)
from repro_torch.core.roofline import (RooflineTerms,
                                      roofline_from_artifacts,
                                      format_roofline_row)
from repro_torch.core.sass import (SassFunction, SassCensus, parse_sass,
                                  census, fit_trips, use_sass)
