"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here needs a CUDA device and skips without one (the
decision is taken inside the fixture, never at import).  Run them on the
H100 with ``PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py``.

Tolerances are those of ``tests/test_kernels.py`` (2e-4 for float32,
2e-2 for bfloat16): both sides accumulate in f32, in different orders.
TF32 is switched off so the plain float32 products stay IEEE f32.
"""
import ctypes

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels import _cuda, api, ops
from repro_torch.kernels.flash_attention import (BLOCKED_TILES, FLASH_TILES,
                                                 attention_plain,
                                                 blocked_cuda, flash_cuda)
from repro_torch.kernels.matmul import GEMM_TILES, matmul_cuda, matmul_plain
from repro_torch.kernels.mlp_matmul import (GATED_TILES, STREAM_TILES,
                                            fused_cuda, mlp_plain,
                                            split_cuda, stream_cuda)
from repro_torch.kernels.rms_norm import (RMS_TILES, rms_norm_cuda,
                                          rms_norm_plain)

DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16 \
        else dict(rtol=2e-4, atol=2e-4)


def _rand(shape, dtype, device, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(shape).astype(np.float32) * scale
    return torch.from_numpy(a).to(device=device, dtype=dtype)


def _close(got, want, dtype):
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


@pytest.mark.parametrize("kind,table", [
    (0, GEMM_TILES), (1, GATED_TILES), (2, STREAM_TILES), (3, RMS_TILES),
    (4, FLASH_TILES), (5, BLOCKED_TILES)])
def test_tile_tables_match_the_library(cuda, kind, table):
    """The Python tile tables name the C side's instantiations in order."""
    lib = _cuda.library()
    assert lib.repro_tile_count(kind) == len(table)
    out = (ctypes.c_int * 6)()
    for i, fields in enumerate(table.values()):
        assert lib.repro_tile_info(kind, i, out) == 0
        slots = {2: (0, 1, 3, 4), 3: (0,), 4: (0, 1, 5), 5: (0, 5)}.get(
            kind, (0, 1, 2, 3, 4))
        assert tuple(out[j] for j in slots) == tuple(fields), (kind, i)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("tile", list(GEMM_TILES))
@pytest.mark.parametrize("m,n,k", [(4, 96, 200), (130, 70, 64)])
def test_matmul_kernel(cuda, dtype, tile, m, n, k):
    a = _rand((m, k), dtype, cuda, 0)
    b = _rand((k, n), dtype, cuda, 1, scale=k ** -0.5)
    got = matmul_cuda(a, b, tile=tile)
    torch.cuda.synchronize()
    _close(got, matmul_plain(a, b), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("tile", list(RMS_TILES))
def test_rms_norm_kernel(cuda, dtype, tile):
    x = _rand((37, 300), dtype, cuda, 2)
    w = _rand((300,), torch.float32, cuda, 3)
    got = rms_norm_cuda(x, w, 1e-6, tile=tile)
    torch.cuda.synchronize()
    _close(got, rms_norm_plain(x, w, 1e-6), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("tile", list(FLASH_TILES))
def test_flash_kernel(cuda, dtype, causal, tile):
    q, k, v = (_rand((2, 3, 80, 64), dtype, cuda, s) for s in (4, 5, 6))
    got = flash_cuda(q, k, v, causal, tile=tile)
    torch.cuda.synchronize()
    _close(got, attention_plain(q, k, v, causal), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("tile", list(BLOCKED_TILES))
def test_blocked_kernel(cuda, dtype, causal, tile):
    q, k, v = (_rand((2, 3, 48, 64), dtype, cuda, s) for s in (7, 8, 9))
    got = blocked_cuda(q, k, v, causal, tile=tile)
    torch.cuda.synchronize()
    _close(got, attention_plain(q, k, v, causal), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("variant,fn,tiles", [
    ("fused", fused_cuda, GATED_TILES), ("stream", stream_cuda, STREAM_TILES),
    ("split", split_cuda, GEMM_TILES)])
def test_gated_mlp_kernels(cuda, dtype, act, variant, fn, tiles):
    x = _rand((5, 96), dtype, cuda, 10)
    wg = _rand((96, 72), dtype, cuda, 11, scale=96 ** -0.5)
    wu = _rand((96, 72), dtype, cuda, 12, scale=96 ** -0.5)
    want = mlp_plain(x, wg, wu, act)
    for tile in tiles:
        got = fn(x, wg, wu, act, tile=tile)
        torch.cuda.synchronize()
        _close(got, want, dtype)


def test_ops_dispatch_launches_the_kernels(cuda):
    """Through `ops` under the H100 target every op launches its CUDA
    kernel (the launch counters move) and agrees with its plain
    version."""
    from repro_torch.core.target import use_target
    kernels.reset_launch_counts()
    x = _rand((8, 64), torch.float32, cuda, 20)
    w = torch.ones(64, device=cuda)
    with use_target("h100"):
        _close(ops.rms_norm(x, w), rms_norm_plain(x, w), torch.float32)
        wd = _rand((64, 32), torch.float32, cuda, 21, scale=0.125)
        _close(ops.matmul(x, wd), matmul_plain(x, wd), torch.float32)
    counts = kernels.launch_counts()
    assert counts["rms_norm"] == 1 and counts["matmul"] == 1


def test_wrapper_raises_on_a_refused_launch(cuda):
    """A launch the card refuses is reported, not silently skipped."""
    q = _rand((1, 1, 64, 8192), torch.float32, cuda, 30)
    with pytest.raises(RuntimeError, match="CUDA error"):
        blocked_cuda(q, q, q, True, tile="q64")


def test_fallback_tile_is_feasible_at_the_serve_shapes(cuda):
    spec = api.get_spec("mlp_matmul")
    vid, tile = spec.fallback_tile("stream", m=256, d=3072, f=24576,
                                   act="gelu", dtype="bfloat16")
    assert vid in ("stream", "fused") and tile
