"""The reference's distribution layer: the sharding rule tables and
resolver, `NamedSharding` on a torch ``DeviceMesh``, the `Sharder`, the
training step (one device or a mesh, with the int8 pod-gradient
compression) and the serving functions."""
from repro_torch.distributed.compression import (dequantize_int8,
                                                 ef_compress_grads,
                                                 init_ef_state,
                                                 quantize_int8)
from repro_torch.distributed.sharding import (ACT_RULES, CACHE_RULES,
                                              CACHE_RULES_SEQSHARD,
                                              NamedSharding, Rules,
                                              Sharder, WEIGHT_RULES,
                                              logical_spec, named_sharding,
                                              tree_shardings)
from repro_torch.distributed.train import (TrainStepConfig, make_serve_fns,
                                           make_train_step,
                                           recommended_microbatches)
