"""Single-device stand-ins for the reference's distribution layer."""
from repro_torch.distributed.sharding import Sharder
from repro_torch.distributed.train import make_serve_fns
