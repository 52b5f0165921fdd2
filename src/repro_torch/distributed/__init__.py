"""The reference's distribution layer on one device: the sharding rule
tables and resolver, the one-device `Sharder`, the training step and
the serving functions.  Meshes wait for ROADMAP A8b."""
from repro_torch.distributed.sharding import (ACT_RULES, CACHE_RULES,
                                              CACHE_RULES_SEQSHARD, Rules,
                                              Sharder, WEIGHT_RULES,
                                              logical_spec)
from repro_torch.distributed.train import (TrainStepConfig, make_serve_fns,
                                           make_train_step,
                                           recommended_microbatches)
