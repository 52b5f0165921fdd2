from repro_torch.optim.adamw import (AdamWConfig, adamw_update, global_norm,
                                     init_adamw, schedule)
