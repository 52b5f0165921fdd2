"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here needs a CUDA device and skips without one (the
decision is taken inside the fixture, never at import).  Run them on the
H100 with ``PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py``.

Tolerances are those of ``tests/test_kernels.py`` (2e-4 for float32 —
1e-3 for atax and BiCG, 1e-5 for the Jacobi sweeps, 1e-6 for saxpy2d —
and 2e-2 for bfloat16): both sides accumulate in f32, in different
orders.
TF32 is switched off so the plain float32 products stay IEEE f32.
"""
import ctypes
import importlib
import sys

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels import _cuda, api, ops
from repro_torch.kernels.atax import BLAS2_TILES, atax_cuda, atax_plain
from repro_torch.kernels.bicg import bicg_cuda, bicg_plain
from repro_torch.kernels.flash_attention import (BLOCKED_TILES, FLASH_TILES,
                                                 MMA, TC, TF32,
                                                 attention_plain,
                                                 blocked_cuda, flash_cuda)
from repro_torch.kernels.flash_attention import SIMT as ATTN_SIMT
from repro_torch.kernels.jacobi3d import (JACOBI_TILES, RING, jacobi3d_cuda,
                                          jacobi3d_plain, ring_takes)
from repro_torch.kernels.matmul import (GEMM_TILES, GEMV, SIMT, WGMMA,
                                        matmul_cuda, matmul_plain,
                                        wgmma_takes)
from repro_torch.kernels.matvec import MATVEC_TILES, matvec_cuda, matvec_plain
from repro_torch.kernels.mlp_matmul import (GATED_TILES, STREAM_TILES,
                                            fused_cuda, mlp_plain,
                                            split_cuda, stream_cuda)
from repro_torch.kernels.rms_norm import (CLUSTER, RMS_TILES, VEC,
                                          cluster_takes, rms_norm_cuda,
                                          rms_norm_plain, vec_takes)
from repro_torch.kernels.rms_norm import SIMT as RMS_SIMT
from repro_torch.kernels.stencil2d import RING as STENCIL_RING
from repro_torch.kernels.stencil2d import (STENCIL_TILES, stencil2d_cuda,
                                           stencil2d_plain)

DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _tol(dtype, f32=2e-4):
    return dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16 \
        else dict(rtol=f32, atol=f32)


def _rand(shape, dtype, device, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(shape).astype(np.float32) * scale
    return torch.from_numpy(a).to(device=device, dtype=dtype)


def _close(got, want, dtype, f32=2e-4):
    torch.testing.assert_close(got.float(), want.float(),
                               **_tol(dtype, f32))


@pytest.mark.parametrize("kind,table", [
    (0, GEMM_TILES), (1, GATED_TILES), (2, STREAM_TILES), (3, RMS_TILES),
    (4, FLASH_TILES), (5, BLOCKED_TILES), (6, MATVEC_TILES),
    (7, BLAS2_TILES), (8, BLAS2_TILES), (9, JACOBI_TILES)])
def test_tile_tables_match_the_library(cuda, kind, table):
    """The Python tile tables name the C side's instantiations in order
    (the GEMM, gated and stream tables with their family, stages and
    split fields), through a buffer of the width the C interface
    declares."""
    lib = _cuda.library()
    assert lib.repro_tile_count(kind) == len(table)
    out = (ctypes.c_int * _cuda.TILE_INFO_INTS)()
    for i, fields in enumerate(table.values()):
        assert lib.repro_tile_info(kind, i, out) == 0
        slots = {0: (0, 1, 2, 3, 4, 6, 7, 8), 1: (0, 1, 2, 3, 4, 6, 7, 8),
                 2: (0, 1, 2, 3, 4, 6, 7, 8),
                 3: (0, 5, 1, 2, 3), 4: (0, 1, 5, 6), 5: (0, 5, 6),
                 6: (0, 1), 7: (0, 1), 8: (0, 1)}.get(kind,
                                                      (0, 1, 2, 3, 4))
        assert tuple(out[j] for j in slots) == tuple(fields), (kind, i)
    threads = {SIMT: None, GEMV: 256, WGMMA: 384}
    if kind in (0, 1, 2):
        for i, fields in enumerate(table.values()):
            lib.repro_tile_info(kind, i, out)
            want = threads[fields[5]] or (fields[0] // fields[3]) * (
                fields[1] // fields[4])
            assert out[5] == want, (i, fields)


def _takes(tile, dtype, n, k):
    """Whether ``tile`` takes the product (wgmma rows: bf16, K and N
    multiples of 8); the wrapper refuses the rest with ValueError."""
    return GEMM_TILES[tile][5] != WGMMA or wgmma_takes(
        str(dtype).rpartition(".")[2], n, k)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("tile", list(GEMM_TILES))
@pytest.mark.parametrize("m,n,k", [(4, 96, 200), (130, 70, 64)])
def test_matmul_kernel(cuda, dtype, tile, m, n, k):
    a = _rand((m, k), dtype, cuda, 0)
    b = _rand((k, n), dtype, cuda, 1, scale=k ** -0.5)
    if not _takes(tile, dtype, n, k):
        with pytest.raises(ValueError, match="takes bfloat16"):
            matmul_cuda(a, b, tile=tile)
        return
    got = matmul_cuda(a, b, tile=tile)
    torch.cuda.synchronize()
    _close(got, matmul_plain(a, b), dtype)


NEW_ROWS = [t for t, f in GEMM_TILES.items() if f[5] != SIMT]
# every GEMV and wgmma row on every shape and dtype it takes: ragged M
# and N, K not a multiple of SPLIT x BK (200 and 64 against splits up to
# 32, so some K slices are empty), and the serving prefill shape
FAMILY_CASES = [(tile, dtype, shape) for tile in NEW_ROWS
                for dtype in DTYPES
                for shape in [(4, 96, 200), (130, 70, 64), (130, 136, 200),
                              (256, 3072, 24576)]
                if _takes(tile, dtype, shape[1], shape[2])]


@pytest.mark.parametrize("tile,dtype,shape", FAMILY_CASES,
                         ids=[f"{t}-{str(d)[6:]}-{'x'.join(map(str, s))}"
                              for t, d, s in FAMILY_CASES])
def test_gemm_family_rows_against_plain(cuda, tile, dtype, shape):
    """Each new row against the plain version; two calls give the same
    bits (the split-K sums run in a fixed order)."""
    m, n, k = shape
    a = _rand((m, k), dtype, cuda, 2)
    b = _rand((k, n), dtype, cuda, 3, scale=k ** -0.5)
    got = matmul_cuda(a, b, tile=tile)
    again = matmul_cuda(a, b, tile=tile)
    torch.cuda.synchronize()
    _close(got, matmul_plain(a, b), dtype)
    assert torch.equal(got, again)


@pytest.mark.parametrize("tile", [t for t in NEW_ROWS
                                  if GEMM_TILES[t][5] == WGMMA])
def test_wgmma_rows_refuse_what_they_cannot_take(cuda, tile):
    """f32 operands, N or K not a multiple of 8, an unaligned base: a
    ValueError before any launch."""
    f32 = _rand((8, 64), torch.float32, cuda, 4)
    with pytest.raises(ValueError, match="takes bfloat16"):
        matmul_cuda(f32, _rand((64, 64), torch.float32, cuda, 5), tile=tile)
    a = _rand((8, 64), torch.bfloat16, cuda, 6)
    with pytest.raises(ValueError, match="takes bfloat16"):
        matmul_cuda(a, _rand((64, 70), torch.bfloat16, cuda, 7), tile=tile)
    with pytest.raises(ValueError, match="takes bfloat16"):
        matmul_cuda(_rand((8, 60), torch.bfloat16, cuda, 8),
                    _rand((60, 64), torch.bfloat16, cuda, 9), tile=tile)
    flat = _rand((1 + 8 * 64,), torch.bfloat16, cuda, 10)
    with pytest.raises(ValueError, match="16-byte-aligned"):
        matmul_cuda(flat[1:].view(8, 64),
                    _rand((64, 64), torch.bfloat16, cuda, 11), tile=tile)


@pytest.mark.parametrize("tile", NEW_ROWS)
def test_split_mlp_takes_the_new_rows_with_f32_passes(cuda, tile):
    """`split_cuda`'s two GEMM passes store f32 (out_f32) through the
    new rows, at the decode shape of the serving path."""
    x = _rand((4, 3072), torch.bfloat16, cuda, 12)
    wg = _rand((3072, 1024), torch.bfloat16, cuda, 13, scale=3072 ** -0.5)
    wu = _rand((3072, 1024), torch.bfloat16, cuda, 14, scale=3072 ** -0.5)
    got = split_cuda(x, wg, wu, "gelu", tile=tile)
    torch.cuda.synchronize()
    _close(got, mlp_plain(x, wg, wu, "gelu"), torch.bfloat16)


RMS_WARP_ROWS = [t for t, f in RMS_TILES.items() if f[2] == RMS_SIMT]
RMS_VEC_ROWS = [t for t, f in RMS_TILES.items() if f[2] == VEC]
RMS_CLUSTER_ROWS = [t for t, f in RMS_TILES.items() if f[2] == CLUSTER]
FLASH_SIMT_ROWS = [t for t, f in FLASH_TILES.items() if f[3] == ATTN_SIMT]
FLASH_MMA_ROWS = [t for t, f in FLASH_TILES.items() if f[3] == MMA]
FLASH_TF32_ROWS = [t for t, f in FLASH_TILES.items() if f[3] == TF32]
BLOCKED_TC_ROWS = [t for t, f in BLOCKED_TILES.items() if f[2] == TC]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("tile", RMS_WARP_ROWS)
def test_rms_norm_kernel(cuda, dtype, tile):
    x = _rand((37, 300), dtype, cuda, 2)
    w = _rand((300,), torch.float32, cuda, 3)
    got = rms_norm_cuda(x, w, 1e-6, tile=tile)
    torch.cuda.synchronize()
    _close(got, rms_norm_plain(x, w, 1e-6), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("tile", RMS_VEC_ROWS)
@pytest.mark.parametrize("d", [2048, 3072, 4096])
@pytest.mark.parametrize("m", [1, 4, 37, 256])
def test_rms_vec_rows_against_plain(cuda, dtype, tile, d, m):
    """Each vector row against the plain version where it holds the row
    (ValueError before any launch where it does not); two calls give
    the same bits (the partial sums meet in warp order)."""
    x = _rand((m, d), dtype, cuda, 70)
    w = _rand((d,), torch.float32, cuda, 71)
    if not vec_takes(str(dtype).rpartition(".")[2], d, RMS_TILES[tile][1]):
        with pytest.raises(ValueError, match="16-byte vectors"):
            rms_norm_cuda(x, w, 1e-6, tile=tile)
        return
    got = rms_norm_cuda(x, w, 1e-6, tile=tile)
    again = rms_norm_cuda(x, w, 1e-6, tile=tile)
    torch.cuda.synchronize()
    _close(got, rms_norm_plain(x, w, 1e-6), dtype)
    assert torch.equal(got, again)


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 300),
                                     (torch.bfloat16, 301),
                                     (torch.float32, 301)])
@pytest.mark.parametrize("tile", RMS_VEC_ROWS)
def test_rms_vec_rows_refuse_ragged_rows(cuda, dtype, d, tile):
    """Rows that are not whole 16-byte vectors (D = 300 is 75 of them in
    float32, which the vector rows take): a ValueError before any
    launch."""
    x = _rand((37, d), dtype, cuda, 72)
    w = _rand((d,), torch.float32, cuda, 73)
    with pytest.raises(ValueError, match="16-byte vectors"):
        rms_norm_cuda(x, w, 1e-6, tile=tile)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("tile", RMS_CLUSTER_ROWS)
@pytest.mark.parametrize("d", [3072, 8192, 8200, 16384, 16392, 24576,
                               32768])
@pytest.mark.parametrize("m", [1, 4, 37])
def test_rms_cluster_rows_against_plain(cuda, dtype, tile, d, m):
    """Each cluster row against the plain version where it holds the row
    (ValueError before any launch where it does not): at and just past
    the vector rows' limit (8192 f32, 16384 bf16), gemma-7b's d_ff; two
    calls give the same bits (the slices' sums meet in rank order)."""
    x = _rand((m, d), dtype, cuda, 74)
    w = _rand((d,), torch.float32, cuda, 75)
    _, threads, _, _, c = RMS_TILES[tile]
    if not cluster_takes(str(dtype).rpartition(".")[2], d, threads, c):
        with pytest.raises(ValueError, match="16-byte vectors"):
            rms_norm_cuda(x, w, 1e-6, tile=tile)
        return
    got = rms_norm_cuda(x, w, 1e-6, tile=tile)
    again = rms_norm_cuda(x, w, 1e-6, tile=tile)
    torch.cuda.synchronize()
    _close(got, rms_norm_plain(x, w, 1e-6), dtype)
    assert torch.equal(got, again)


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 24570),
                                     (torch.bfloat16, 300),
                                     (torch.float32, 301),
                                     (torch.bfloat16, 131080),
                                     (torch.float32, 65540)])
@pytest.mark.parametrize("tile", RMS_CLUSTER_ROWS)
def test_rms_cluster_rows_refuse_ragged_and_too_long_rows(cuda, dtype, d,
                                                          tile):
    """Rows that are not whole 16-byte vectors, or longer than C blocks
    of registers hold (131080 bf16 and 65540 f32 are past every cluster
    row): a ValueError before any launch."""
    x = _rand((4, d), dtype, cuda, 76)
    w = _rand((d,), torch.float32, cuda, 77)
    with pytest.raises(ValueError, match="16-byte vectors"):
        rms_norm_cuda(x, w, 1e-6, tile=tile)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("tile", FLASH_SIMT_ROWS)
def test_flash_kernel(cuda, dtype, causal, tile):
    q, k, v = (_rand((2, 3, 80, 64), dtype, cuda, s) for s in (4, 5, 6))
    got = flash_cuda(q, k, v, causal, tile=tile)
    torch.cuda.synchronize()
    _close(got, attention_plain(q, k, v, causal), dtype)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("tile", FLASH_MMA_ROWS)
def test_flash_mma_rows_against_plain(cuda, tile, d, causal):
    """Each tensor-core row on a ragged sq (80 against every BQ and
    BKV), bf16, against the plain version; two calls give the same
    bits."""
    q, k, v = (_rand((2, 3, 80, d), torch.bfloat16, cuda, s)
               for s in (74, 75, 76))
    got = flash_cuda(q, k, v, causal, tile=tile)
    again = flash_cuda(q, k, v, causal, tile=tile)
    torch.cuda.synchronize()
    _close(got, attention_plain(q, k, v, causal), torch.bfloat16)
    assert torch.equal(got, again)


@pytest.mark.parametrize("tile", FLASH_MMA_ROWS)
def test_flash_mma_rows_refuse_what_they_cannot_take(cuda, tile):
    """f32 operands, d not a multiple of 16 or past 256: a ValueError
    before any launch."""
    f32 = _rand((1, 2, 16, 64), torch.float32, cuda, 77)
    with pytest.raises(ValueError, match="takes bfloat16"):
        flash_cuda(f32, f32, f32, True, tile=tile)
    for d in (72, 272):
        b = _rand((1, 2, 16, d), torch.bfloat16, cuda, 78)
        with pytest.raises(ValueError, match="takes bfloat16"):
            flash_cuda(b, b, b, True, tile=tile)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [32, 64, 128, 256])
@pytest.mark.parametrize("tile", FLASH_TF32_ROWS)
def test_flash_tf32_rows_against_plain(cuda, tile, d, causal):
    """Each 3xTF32 row on a ragged sq (80 against every BQ and BKV),
    float32, against the plain version at the f32 tolerance; two calls
    give the same bits.  At d = 256 a 64-row KV tile needs two f32
    stages past one tile of skv, which do not fit: a ValueError before
    any launch."""
    q, k, v = (_rand((2, 3, 80, d), torch.float32, cuda, s)
               for s in (80, 81, 82))
    if d == 256 and FLASH_TILES[tile][1] == 64:
        with pytest.raises(ValueError, match="shared memory"):
            flash_cuda(q, k, v, causal, tile=tile)
        return
    got = flash_cuda(q, k, v, causal, tile=tile)
    again = flash_cuda(q, k, v, causal, tile=tile)
    torch.cuda.synchronize()
    _close(got, attention_plain(q, k, v, causal), torch.float32)
    assert torch.equal(got, again)


@pytest.mark.parametrize("tile", FLASH_TF32_ROWS)
def test_flash_tf32_rows_refuse_what_they_cannot_take(cuda, tile):
    """bf16 operands, d not a multiple of 8 or past 256: a ValueError
    before any launch."""
    b = _rand((1, 2, 16, 64), torch.bfloat16, cuda, 83)
    with pytest.raises(ValueError, match="takes float32"):
        flash_cuda(b, b, b, True, tile=tile)
    for d in (36, 264):
        f = _rand((1, 2, 16, d), torch.float32, cuda, 84)
        with pytest.raises(ValueError, match="takes float32"):
            flash_cuda(f, f, f, True, tile=tile)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [32, 64, 128, 256])
@pytest.mark.parametrize("tile", BLOCKED_TC_ROWS)
def test_blocked_tc_rows_against_plain(cuda, tile, d, causal, dtype):
    """Each blocked tensor-core row on a ragged sq (48: past every BQ
    but 64, and a K/V of three 16-row pairs), bf16 and float32 (3xTF32),
    against the plain version; two calls give the same bits."""
    q, k, v = (_rand((2, 3, 48, d), dtype, cuda, s) for s in (85, 86, 87))
    got = blocked_cuda(q, k, v, causal, tile=tile)
    again = blocked_cuda(q, k, v, causal, tile=tile)
    torch.cuda.synchronize()
    _close(got, attention_plain(q, k, v, causal), dtype)
    assert torch.equal(got, again)


@pytest.mark.parametrize("tile", BLOCKED_TC_ROWS)
def test_blocked_tc_rows_refuse_what_they_cannot_take(cuda, tile):
    """d not a whole MMA step of its type (72 in bf16, 36 in float32) or
    past 256, and a K and V too long for shared memory (skv = 256 at d
    = 256 in bf16, 128 in float32): a ValueError before any launch."""
    for dtype, d in ((torch.bfloat16, 72), (torch.float32, 36),
                     (torch.bfloat16, 272), (torch.float32, 264)):
        x = _rand((1, 2, 16, d), dtype, cuda, 88)
        with pytest.raises(ValueError, match="takes bfloat16"):
            blocked_cuda(x, x, x, True, tile=tile)
    for dtype, skv in ((torch.bfloat16, 256), (torch.float32, 128)):
        q = _rand((1, 2, 16, 256), dtype, cuda, 89)
        kv = _rand((1, 2, skv, 256), dtype, cuda, 90)
        with pytest.raises(ValueError, match="shared memory"):
            blocked_cuda(q, kv, kv, True, tile=tile)
    # skv = 128 at d = 256 in bf16 fits every row
    q = _rand((1, 2, 16, 256), torch.bfloat16, cuda, 91)
    kv = _rand((1, 2, 128, 256), torch.bfloat16, cuda, 92)
    got = blocked_cuda(q, kv, kv, False, tile=tile)
    torch.cuda.synchronize()
    _close(got, attention_plain(q, kv, kv, False), torch.bfloat16)


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
        if tiles[tile][5] == WGMMA and not wgmma_takes(
                str(dtype).rpartition(".")[2], 72, 96):
            with pytest.raises(ValueError, match="takes bfloat16"):
                fn(x, wg, wu, act, tile=tile)
            continue
        got = fn(x, wg, wu, act, tile=tile)
        torch.cuda.synchronize()
        _close(got, want, dtype)


GATED_WGMMA_ROWS = [t for t, f in GATED_TILES.items() if f[5] == WGMMA]
STREAM_GEMV_ROWS = [t for t, f in STREAM_TILES.items() if f[5] == GEMV]
ACTS = ["silu", "gelu", "relu"]
# (M, D, F) for the gated wgmma rows: one live warpgroup, a ragged
# second row tile and a ragged last column tile, D not a whole number
# of 64-deep k-blocks, and the serving prefill shape
GATED_SHAPES = [(5, 96, 72), (130, 136, 200), (64, 200, 1000),
                (256, 3072, 24576)]
# (M, D, F) for the stream GEMV rows: M under, at and over BM (a grid
# of row blocks), D not a whole number of chunks and D * eb not a
# multiple of 16 (x copied without the bulk copy), F ragged against
# every BN and not a whole number of 16-byte vectors (scalar lanes),
# and the serving decode shapes
STREAM_SHAPES = [(1, 96, 72), (5, 100, 70), (9, 200, 1003),
                 (4, 3072, 24576), (1, 3072, 24576)]


def _mlp_operands(shape, dtype, device, seed):
    """x, W_gate, W_up drawn on the card (the serving shapes' weights are
    75M values each)."""
    m, d, f = shape
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return tuple((torch.randn(s, generator=g, device=device) * c).to(dtype)
                 for s, c in (((m, d), 1.0), ((d, f), d ** -0.5),
                              ((d, f), d ** -0.5)))


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("shape", GATED_SHAPES,
                         ids=["x".join(map(str, s)) for s in GATED_SHAPES])
@pytest.mark.parametrize("tile", GATED_WGMMA_ROWS)
def test_gated_wgmma_rows_against_plain(cuda, tile, shape, act):
    """Each TMA + wgmma gated row against the plain version in bf16 (the
    rows take no other type), counted under its family."""
    x, wg, wu = _mlp_operands(shape, torch.bfloat16, cuda, 40)
    before = dict(kernels.launch_counts())
    got = fused_cuda(x, wg, wu, act, tile=tile)
    torch.cuda.synchronize()
    _close(got, mlp_plain(x, wg, wu, act), torch.bfloat16)
    after = kernels.launch_counts()
    assert after["gated_wgmma"] == before["gated_wgmma"] + 1
    assert after["fused"] == before["fused"] + 1


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("shape", STREAM_SHAPES,
                         ids=["x".join(map(str, s)) for s in STREAM_SHAPES])
@pytest.mark.parametrize("tile", STREAM_GEMV_ROWS)
def test_stream_gemv_rows_against_plain(cuda, tile, shape, act, dtype):
    """Each whole-D gated GEMV row against the plain version; two calls
    give the same bits (fixed butterfly, then warp order)."""
    x, wg, wu = _mlp_operands(shape, dtype, cuda, 50)
    before = dict(kernels.launch_counts())
    got = stream_cuda(x, wg, wu, act, tile=tile)
    again = stream_cuda(x, wg, wu, act, tile=tile)
    torch.cuda.synchronize()
    _close(got, mlp_plain(x, wg, wu, act), dtype)
    assert torch.equal(got, again)
    after = kernels.launch_counts()
    assert after["stream_gemv"] == before["stream_gemv"] + 2
    assert after["stream"] == before["stream"] + 2


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("tile", STREAM_GEMV_ROWS)
def test_stream_gemv_rows_take_unaligned_operands(cuda, tile, dtype):
    """x and the weights as views one element off 16-byte alignment: x
    through the ordinary copy, the weights through masked scalar loads."""
    m, d, f = 4, 96, 136
    flat = _rand((1 + m * d + 2 * (1 + d * f),), dtype, cuda, 60, scale=0.1)
    x = flat[1:1 + m * d].view(m, d)
    o = 1 + m * d
    wg = flat[o + 1:o + 1 + d * f].view(d, f)
    wu = flat[o + 2 + d * f:o + 2 + 2 * d * f].view(d, f)
    got = stream_cuda(x, wg, wu, "gelu", tile=tile)
    torch.cuda.synchronize()
    _close(got, mlp_plain(x, wg, wu, "gelu"), dtype)


@pytest.mark.parametrize("tile", GATED_WGMMA_ROWS + STREAM_GEMV_ROWS)
def test_new_mlp_rows_refuse_what_they_cannot_take(cuda, tile):
    """The gated wgmma rows: float32, D or F not a multiple of 8, an
    unaligned base; the stream GEMV rows: an x panel past 227 KB.  A
    ValueError before any launch."""
    if tile in GATED_WGMMA_ROWS:
        for dtype, (m, d, f) in ((torch.float32, (8, 64, 64)),
                                 (torch.bfloat16, (8, 60, 64)),
                                 (torch.bfloat16, (8, 64, 70))):
            x, wg, wu = _mlp_operands((m, d, f), dtype, cuda, 70)
            with pytest.raises(ValueError, match="takes bfloat16"):
                fused_cuda(x, wg, wu, "silu", tile=tile)
        _, wg, wu = _mlp_operands((8, 64, 64), torch.bfloat16, cuda, 73)
        flat = _rand((1 + 8 * 64,), torch.bfloat16, cuda, 76)
        with pytest.raises(ValueError, match="16-byte-aligned"):
            fused_cuda(flat[1:].view(8, 64), wg, wu, "silu", tile=tile)
        return
    bm = STREAM_TILES[tile][0]
    d = 232448 // (4 * bm) + 16           # f32: the panel alone is too big
    x, wg, wu = _mlp_operands((bm, d, 64), torch.float32, cuda, 77)
    with pytest.raises(ValueError, match="does not fit"):
        stream_cuda(x, wg, wu, "silu", tile=tile)


# (M, N): 16-byte vector loads for both types, for float32 only
# (N % 8 == 4), and the scalar path (N odd); M ragged against every
# ROWS and stripe.
BLAS2_SHAPES = [(64, 256), (37, 300), (130, 1001)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("tile", list(MATVEC_TILES))
@pytest.mark.parametrize("m,n", BLAS2_SHAPES)
def test_matvec_kernel(cuda, dtype, tile, m, n):
    a = _rand((m, n), dtype, cuda, 40)
    x = _rand((n, 1), dtype, cuda, 41)
    got = matvec_cuda(a, x, tile=tile)
    torch.cuda.synchronize()
    _close(got, matvec_plain(a, x), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("tile", list(BLAS2_TILES))
@pytest.mark.parametrize("m,n", BLAS2_SHAPES)
def test_atax_kernel(cuda, dtype, tile, m, n):
    a = _rand((m, n), dtype, cuda, 42, scale=n ** -0.5)
    x = _rand((n, 1), dtype, cuda, 43)
    got = atax_cuda(a, x, tile=tile)
    torch.cuda.synchronize()
    _close(got, atax_plain(a, x), dtype, f32=1e-3)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("tile", list(BLAS2_TILES))
@pytest.mark.parametrize("m,n", BLAS2_SHAPES)
def test_bicg_kernel(cuda, dtype, tile, m, n):
    a = _rand((m, n), dtype, cuda, 44, scale=n ** -0.5)
    p = _rand((n, 1), dtype, cuda, 45)
    r = _rand((m, 1), dtype, cuda, 46)
    q, s = bicg_cuda(a, p, r, tile=tile)
    torch.cuda.synchronize()
    q2, s2 = bicg_plain(a, p, r)
    _close(q, q2, dtype, f32=1e-3)
    _close(s, s2, dtype, f32=1e-3)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("tile", list(JACOBI_TILES))
@pytest.mark.parametrize("shape", [(5, 37, 70), (40, 9, 33), (1, 4, 4),
                                   (5, 37, 72), (40, 9, 40)])
def test_jacobi3d_kernel(cuda, dtype, tile, shape):
    """Every row of both families; a ring row refuses an X that is not a
    whole number of 16-byte vectors with ValueError before any launch."""
    u = _rand(shape, dtype, cuda, 47)
    if JACOBI_TILES[tile][3] == RING and not ring_takes(
            str(dtype).rpartition(".")[2], shape[2]):
        with pytest.raises(ValueError, match="16-byte rows"):
            jacobi3d_cuda(u, tile=tile)
        return
    got = jacobi3d_cuda(u, tile=tile)
    torch.cuda.synchronize()
    _close(got, jacobi3d_plain(u), dtype, f32=1e-5)


JACOBI_RING_ROWS = [t for t, f in JACOBI_TILES.items() if f[3] == RING]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("tile", JACOBI_RING_ROWS)
@pytest.mark.parametrize("shape", [(3, 4, 8), (37, 20, 40), (1, 12, 16),
                                   (70, 9, 136), (33, 17, 264),
                                   (64, 64, 64)])
def test_jacobi_ring_rows_against_plain(cuda, dtype, tile, shape):
    """Z not a multiple of ZB, Y not of BY, X not of BX, one plane, a
    3x4x8 volume: float32 gives the plain version's bits (0.5 u is
    exact, the neighbours add in the oracle's order), bfloat16 agrees
    within its tolerance; two calls give the same bits."""
    u = _rand(shape, dtype, cuda, 78)
    if not ring_takes(str(dtype).rpartition(".")[2], shape[2]):
        with pytest.raises(ValueError, match="16-byte rows"):
            jacobi3d_cuda(u, tile=tile)
        return
    got = jacobi3d_cuda(u, tile=tile)
    again = jacobi3d_cuda(u, tile=tile)
    torch.cuda.synchronize()
    want = jacobi3d_plain(u)
    _close(got, want, dtype, f32=1e-5)
    if dtype == torch.float32:
        assert torch.equal(got, want)
    assert torch.equal(got, again)


@pytest.mark.parametrize("dtype,x", [(torch.float32, 70),
                                     (torch.float32, 33),
                                     (torch.bfloat16, 36),
                                     (torch.bfloat16, 70)])
@pytest.mark.parametrize("tile", JACOBI_RING_ROWS)
def test_jacobi_ring_rows_refuse_ragged_x(cuda, dtype, x, tile):
    u = _rand((6, 10, x), dtype, cuda, 79)
    with pytest.raises(ValueError, match="16-byte rows"):
        jacobi3d_cuda(u, tile=tile)
    misaligned = _rand((6 * 10 * 64 + 1,), dtype, cuda, 79)[1:].view(
        6, 10, 64)
    with pytest.raises(ValueError, match="16-byte-aligned"):
        jacobi3d_cuda(misaligned, tile=tile)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("tile", ["t32r1", "t256r4", "t1024r1"])
def test_atax_and_bicg_repeat_bitwise(cuda, dtype, tile):
    """No float atomics: the per-block rows add in block order, so a
    second run gives the same bits."""
    a = _rand((3000, 1536), dtype, cuda, 48, scale=1536 ** -0.5)
    x = _rand((1536, 1), dtype, cuda, 49)
    r = _rand((3000, 1), dtype, cuda, 50)
    y1, y2 = atax_cuda(a, x, tile=tile), atax_cuda(a, x, tile=tile)
    (q1, s1), (q2, s2) = (bicg_cuda(a, x, r, tile=tile),
                          bicg_cuda(a, x, r, tile=tile))
    torch.cuda.synchronize()
    assert torch.equal(y1, y2) and torch.equal(q1, q2) \
        and torch.equal(s1, s2)


def test_table4_ops_dispatch_launches_the_kernels(cuda):
    """The paper's kernels through `ops` under the H100 target: each
    launches its CUDA kernel and agrees with its plain version."""
    from repro_torch.core.target import use_target
    kernels.reset_launch_counts()
    a = _rand((96, 200), torch.float32, cuda, 51, scale=200 ** -0.5)
    x = _rand((200, 1), torch.float32, cuda, 52)
    r = _rand((96, 1), torch.float32, cuda, 53)
    u = _rand((6, 20, 40), torch.float32, cuda, 54)
    with use_target("h100"):
        _close(ops.matvec(a, x), matvec_plain(a, x), torch.float32)
        _close(ops.atax(a, x), atax_plain(a, x), torch.float32, f32=1e-3)
        for got, want in zip(ops.bicg(a, x, r), bicg_plain(a, x, r)):
            _close(got, want, torch.float32, f32=1e-3)
        _close(ops.jacobi3d(u), jacobi3d_plain(u), torch.float32, f32=1e-5)
    counts = kernels.launch_counts()
    assert all(counts[k] == 1 for k in ("matvec", "atax", "bicg",
                                        "jacobi3d")), counts


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


# ---------------------------------------------------------------------------
# the extension path: stencil2d (kernels/) and saxpy2d (examples/)
# ---------------------------------------------------------------------------

# ragged against every tile, a grid of boundary cells only, one row
EXT_SHAPES = [(257, 131), (3, 3), (1, 1000)]
CUSTOM = "repro_torch.examples.custom_kernel"


def _custom_kernel():
    """The example module, imported (so its declaration registers) or
    reloaded if another test unregistered it."""
    mod = sys.modules.get(CUSTOM)
    if mod is None:
        return importlib.import_module(CUSTOM)
    if "saxpy2d" not in api.registered_kernels():
        mod = importlib.reload(mod)
    return mod


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("tile", list(STENCIL_TILES))
@pytest.mark.parametrize("shape", EXT_SHAPES)
def test_stencil2d_kernel(cuda, dtype, tile, shape):
    """Every row of both families; a ring row refuses an X that is not a
    whole number of 16-byte vectors with ValueError before any launch."""
    u = _rand(shape, dtype, cuda, 60)
    if STENCIL_TILES[tile][3] == STENCIL_RING and not ring_takes(
            str(dtype).rpartition(".")[2], shape[1]):
        with pytest.raises(ValueError, match="16-byte rows"):
            stencil2d_cuda(u, tile=tile)
        return
    got = stencil2d_cuda(u, tile=tile)
    torch.cuda.synchronize()
    _close(got, stencil2d_plain(u), dtype, f32=1e-5)


STENCIL_RING_ROWS = [t for t, f in STENCIL_TILES.items()
                     if f[3] == STENCIL_RING]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("tile", STENCIL_RING_ROWS)
@pytest.mark.parametrize("shape", [(1, 16), (2, 8), (3, 24), (7, 8),
                                   (15, 40), (37, 72), (300, 136),
                                   (261, 16), (127, 264), (8192, 512)])
def test_stencil_ring_rows_against_plain(cuda, dtype, tile, shape):
    """Y of 1-3 rows, under RB, not a multiple of RB or R, X of one
    vector and not of BX, and 8192 x 512: the plain version's bits in
    both types (each product and the sum rounded in f32 in one order,
    one rounding to the input type); two calls give the same bits."""
    u = _rand(shape, dtype, cuda, 95)
    got = stencil2d_cuda(u, tile=tile)
    again = stencil2d_cuda(u, tile=tile)
    torch.cuda.synchronize()
    want = stencil2d_plain(u)
    _close(got, want, dtype, f32=1e-5)
    assert torch.equal(got, want)
    assert torch.equal(got, again)


@pytest.mark.parametrize("dtype,x", [(torch.float32, 70),
                                     (torch.float32, 33),
                                     (torch.bfloat16, 36),
                                     (torch.bfloat16, 1003)])
@pytest.mark.parametrize("tile", STENCIL_RING_ROWS)
def test_stencil_ring_rows_refuse_ragged_x_and_unaligned_grids(cuda, dtype,
                                                               x, tile):
    u = _rand((20, x), dtype, cuda, 96)
    with pytest.raises(ValueError, match="16-byte rows"):
        stencil2d_cuda(u, tile=tile)
    misaligned = _rand((20 * 64 + 1,), dtype, cuda, 96)[1:].view(20, 64)
    with pytest.raises(ValueError, match="16-byte-aligned"):
        stencil2d_cuda(misaligned, tile=tile)


def test_stencil_declared_registers_are_the_compiled_counts(cuda):
    """kernels/stencil2d.py's `_REGS` (what the H100 analysis declares)
    against `stencil2d_attrs`, for every row and both types."""
    from repro_torch.kernels import stencil2d
    lib = stencil2d.extension()
    regs, smem, thr = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    for i, tile in enumerate(STENCIL_TILES):
        for dt in (0, 1):
            assert lib.stencil2d_attrs(i, dt, ctypes.byref(regs),
                                       ctypes.byref(smem),
                                       ctypes.byref(thr)) == 0
            assert regs.value == stencil2d._REGS[tile][dt], (tile, dt)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("tile", ["t128v1", "t256v2", "t1024v4"])
@pytest.mark.parametrize("shape", EXT_SHAPES)
def test_saxpy2d_kernel(cuda, dtype, tile, shape):
    ck = _custom_kernel()
    a, b = _rand(shape, dtype, cuda, 61), _rand(shape, dtype, cuda, 62)
    got = ck.saxpy2d_cuda(a, b, tile=tile)
    torch.cuda.synchronize()
    _close(got, ck.saxpy2d_plain(a, b), dtype, f32=1e-6)


@pytest.mark.parametrize("dtype", DTYPES)
def test_saxpy2d_every_tile_and_unaligned_views(cuda, dtype):
    """Every tile on a ragged shape, and on views one element past a
    16-byte boundary (the scalar path)."""
    ck = _custom_kernel()
    a, b = _rand((257, 131), dtype, cuda, 63), _rand((257, 131), dtype,
                                                   cuda, 64)
    flat_a = _rand((1 + 37 * 41,), dtype, cuda, 65)
    flat_b = _rand((1 + 37 * 41,), dtype, cuda, 66)
    va, vb = flat_a[1:].view(37, 41), flat_b[1:].view(37, 41)
    for tile in ck.SAXPY_TILES:
        for x, y in ((a, b), (va, vb)):
            got = ck.saxpy2d_cuda(x, y, tile=tile)
            torch.cuda.synchronize()
            _close(got, ck.saxpy2d_plain(x, y), dtype, f32=1e-6)


def _compiled_table(lib, fn, width):
    out, rows, i = (ctypes.c_int * _cuda.TILE_INFO_INTS)(), [], 0
    while getattr(lib, fn)(i, out) == 0:
        rows.append(tuple(out[j] for j in range(width)))
        i += 1
    return rows


def test_extension_tile_tables_match_their_declarations(cuda):
    """Each extension's compiled table is its declared hopper= tiles,
    in order (stencil2d's with its family and stage fields, and each
    row's threads for float32); and the compiled attributes are readable
    per tile."""
    from repro_torch.kernels import stencil2d
    ck = _custom_kernel()
    rows = _compiled_table(stencil2d.extension(), "stencil2d_tile_info", 6)
    for (bx, by, _, family, _), got in zip(STENCIL_TILES.values(), rows):
        assert got[5] == (bx // 4 * by if family == STENCIL_RING
                          else bx * by)
    for mod, fn, table, width in (
            (stencil2d, "stencil2d_tile_info", STENCIL_TILES, 5),
            (ck, "saxpy2d_tile_info", ck.SAXPY_TILES, 2)):
        lib = mod.extension()
        assert _compiled_table(lib, fn, width) == list(table.values())
        assert api.get_spec(fn.split("_")[0])._hopper[None].tiles == \
            tuple(table)
        regs, smem, thr = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        attrs = getattr(lib, fn.replace("tile_info", "attrs"))
        for i in range(len(table)):
            assert attrs(i, 1, ctypes.byref(regs), ctypes.byref(smem),
                         ctypes.byref(thr)) == 0
            assert 0 < regs.value <= 255


def test_load_extension_reuses_the_cached_library(cuda):
    """A second load in the process returns the loaded library; a new
    process (the in-process memo dropped) loads the cached file instead
    of building."""
    from repro_torch.kernels import stencil2d
    lib = stencil2d.extension()
    assert stencil2d.extension() is lib
    _cuda._exts.pop("stencil2d")
    again = stencil2d.extension()
    log = _cuda.build_log("stencil2d")
    assert log["cached"] and log["build_s"] == 0.0
    u = _rand((40, 50), torch.float32, cuda, 67)
    got = stencil2d_cuda(u, tile="x32y1r16")
    torch.cuda.synchronize()
    _close(got, stencil2d_plain(u), torch.float32, f32=1e-5)
    assert again is not None


def test_load_extension_raises_when_nvcc_fails(cuda, tmp_path):
    bad = tmp_path / "broken.cu"
    bad.write_text("this is not CUDA\n")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _cuda.load_extension("broken", bad, {})


def test_extension_ops_dispatch_launches_the_kernels(cuda):
    """stencil2d and saxpy2d through their generated ops under the H100
    target: each launches its CUDA kernel and agrees with its plain
    version."""
    from repro_torch.core.target import use_target
    ck = _custom_kernel()
    kernels.reset_launch_counts()
    u = _rand((70, 90), torch.float32, cuda, 68)
    a, b = _rand((33, 65), torch.float32, cuda, 69), \
        _rand((33, 65), torch.float32, cuda, 70)
    with use_target("h100"):
        _close(ops.stencil2d(u), stencil2d_plain(u), torch.float32,
               f32=1e-5)
        _close(ops.saxpy2d(a, b), ck.saxpy2d_plain(a, b), torch.float32,
               f32=1e-6)
    counts = kernels.launch_counts()
    assert counts["stencil2d"] == 1 and counts["saxpy2d"] == 1, counts


# the extraction tier on the card's own build: every row of every table
# names a function of the disassembly, whose cuobjdump registers are the
# runtime's numRegs for the same instantiation
SASS_SIGS = {"matmul": dict(m=4, n=3072, k=24576),
             "mlp_matmul": dict(m=4, d=3072, f=24576, act="gelu"),
             "rms_norm": dict(m=4, d=3072),
             "flash_attention": dict(b=4, h=16, sq=64, skv=64, d=256,
                                     causal=True),
             "matvec": dict(m=8192, n=8192), "atax": dict(m=8192, n=8192),
             "bicg": dict(m=8192, n=8192),
             "jacobi3d": dict(z=256, y=256, x=256),
             "stencil2d": dict(y=8192, x=8192),
             "saxpy2d": dict(m=8192, n=8192)}


def test_the_disassembly_names_every_row(cuda):
    from repro_torch.core import sass
    from repro_torch.examples import custom_kernel
    from repro_torch.kernels import stencil2d
    stencil2d.extension()
    custom_kernel.extension()
    text = _cuda.disassemble()
    assert "Function :" in text and "REG:" in text
    assert _cuda.disassemble() == text                # cached beside it
    funcs = {}
    for ext in (None, "stencil2d", "saxpy2d"):
        funcs.update(_cuda.sass_functions(ext))
    for kid, sig in SASS_SIGS.items():
        spec = api.get_spec(kid)
        for vid, h in spec._hopper.items():
            for tile in h.tiles:
                for dt in ("float32", "bfloat16"):
                    for sym in h.symbols(tile, dtype=dt, **sig):
                        fn = sass.find_function(funcs, sym)
                        assert fn is not None, (kid, vid, tile, dt, sym)
                        assert fn.regs > 0 and fn.instructions
                        assert fn.demangled.startswith("void ")


@pytest.mark.parametrize("kind,table,kid", [(0, "gemm", "matmul"),
                                            (3, "rms", "rms_norm")])
def test_disassembled_registers_are_the_runtime_counts(cuda, kind, table,
                                                       kid):
    from repro_torch.core import sass
    funcs = _cuda.sass_functions()
    lib = _cuda.library()
    spec = api.get_spec(kid)
    h = spec._hopper[None]
    regs, smem, thr = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    checked = 0
    for i, tile in enumerate(h.tiles):
        if kid == "matmul" and GEMM_TILES[tile][7] > 1:
            continue        # split rows run f32 slices: another function
        for code, dt in ((0, "float32"), (1, "bfloat16")):
            if lib.repro_kernel_attrs(kind, i, code, ctypes.byref(regs),
                                      ctypes.byref(smem),
                                      ctypes.byref(thr)) != 0:
                continue    # a type the row does not take
            sym = h.symbols(tile, dtype=dt, **SASS_SIGS[kid])[0]
            assert sass.find_function(funcs, sym).regs == regs.value, \
                (tile, dt)
            checked += 1
    assert checked >= len(h.tiles)


# ---------------------------------------------------------------------------
# the optimizer's kernels (csrc/optim.cu): each operation rounds as the
# plain version's eager op does, so the update is bit for bit
# ---------------------------------------------------------------------------

def _leaf(cuda, n, dtype, off, scale, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    full = (torch.randn(n + off, generator=g, device=cuda) * scale).to(dtype)
    return full[off:]


@pytest.mark.parametrize("off", [0, 1], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("n", [7, 1003, 1 << 16])
@pytest.mark.parametrize("gdt", DTYPES, ids=["g_f32", "g_bf16"])
@pytest.mark.parametrize("pdt", DTYPES, ids=["p_f32", "p_bf16"])
def test_adamw_kernel_is_the_plain_update_bit_for_bit(cuda, pdt, gdt, n,
                                                      off):
    from repro_torch.optim.adamw import AdamWConfig, update_with_norm
    p, g = _leaf(cuda, n, pdt, off, 1.0, 1), _leaf(cuda, n, gdt, off, 1e-2, 2)
    m = _leaf(cuda, n, torch.float32, off, 1e-3, 3)
    v = _leaf(cuda, n, torch.float32, off, 1e-3, 4) ** 2
    cfg = AdamWConfig()
    norm = torch.tensor(7.3, device=cuda)
    got = [x.clone() for x in (p, m, v)]
    state = lambda a, b: {"count": torch.tensor(2, dtype=torch.int32,
                                                device=cuda),
                          "m": {"w": a}, "v": {"w": b}}
    update_with_norm({"w": got[0]}, {"w": g}, state(got[1], got[2]), cfg,
                     norm, kernels=True)
    update_with_norm({"w": p}, {"w": g.clone()}, state(m, v), cfg, norm,
                     kernels=False)
    for a, b in zip(got, (p, m, v)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n", [5, 100_003, 1 << 22])
@pytest.mark.parametrize("dtype", DTYPES)
def test_sumsq_kernel_repeats_and_sums_the_squares(cuda, dtype, n):
    from repro_torch.optim.adamw import sumsq
    x = _leaf(cuda, n, dtype, 0, 1.0, 5)
    a, b = sumsq(x), sumsq(x)
    assert torch.equal(a, b) and a.dtype == torch.float32 and a.dim() == 0
    want = torch.sum(torch.square(x.double()))
    assert abs(a.item() - want.item()) <= 1e-6 * want.item()


def test_adamw_update_launches_two_kernels_a_leaf(cuda):
    from repro_torch.models import Param
    from repro_torch.optim import adamw
    shapes = [(64, 32), (1003,), (3, 5, 7)]
    params = {f"w{i}": Param(torch.randn(s, device=cuda), ("a",) * len(s))
              for i, s in enumerate(shapes)}
    grads = {k: torch.randn_like(p.value) for k, p in params.items()}
    state = adamw.init_adamw(params)
    before = dict(adamw.LAUNCHES)
    adamw.adamw_update(params, grads, state, adamw.AdamWConfig())
    torch.cuda.synchronize()
    assert {k: adamw.LAUNCHES[k] - before[k] for k in before} == {
        "sumsq": 3, "adamw": 3}
