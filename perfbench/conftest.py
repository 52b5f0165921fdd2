"""The benchmark's tests run the program's serving set-up inside the
test process, which turns tuned layers on, freezes the dispatch tables
and fills the default tuning database.  Each test gets that state back
as it found it, so that the other tests of a worker see what they would
see alone."""
import pytest
import torch


@pytest.fixture(autouse=True)
def _program_state():
    from repro_torch import tuning_cache
    from repro_torch.kernels import api
    from repro_torch.models.layers import use_tuned_layers
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    with use_tuned_layers(False):
        yield
    tuning_cache.thaw()
    tuning_cache.reset_default_db()
    api.reset_dispatch_stats()
    torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32 = tf32
