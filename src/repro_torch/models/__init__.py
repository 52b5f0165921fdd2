"""The reference's model families in PyTorch (serving path): dense,
moe, ssm, hybrid and encoder-decoder."""
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model, build_model
from repro_torch.models.params import (Param, from_numpy_tree, map_params,
                                       param, resolve_device, stack_dims)
