"""The reference's model families in PyTorch (training loss and serving
path): dense, moe, ssm, hybrid and encoder-decoder."""
from repro_torch.models.config import LM_SHAPES, ModelConfig, ShapeSpec
from repro_torch.models.model import Model, batch_shapes, build_model
from repro_torch.models.params import (Param, device_put, from_numpy_tree,
                                       map_params, param, param_shardings,
                                       resolve_device, stack_dims,
                                       tree_param_bytes, tree_param_count)
