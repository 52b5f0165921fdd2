"""The port's kernel modules against the reference's Pallas kernels.

Each kernel's plain PyTorch version — what its wrapper runs for CPU
tensors, and what the CUDA kernel is held against on the card
(``tests/test_torch_cuda.py``) — must compute the reference Pallas
kernel's function: the same numpy inputs (``np.random.default_rng``)
go through the Pallas kernel in interpret mode, as the reference's own
tests run it, and through the port, at the tolerances of
``tests/test_kernels.py`` (2e-4 float32, 2e-2 bfloat16).  The oracles of
``repro_torch.kernels.ref`` are held against the reference's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import (blocked_attention_pallas,
                                           flash_attention_pallas)
from repro.kernels.matmul import matmul_pallas
from repro.kernels.mlp_matmul import (mlp_matmul_fused_pallas,
                                      mlp_matmul_split_pallas,
                                      mlp_matmul_stream_pallas)
from repro.kernels.rms_norm import rms_norm_pallas
from repro_torch.kernels import _cuda, ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import (attention_plain,
                                                 blocked_attention,
                                                 flash_attention, flash_cuda)
from repro_torch.kernels.matmul import matmul, matmul_cuda, matmul_plain
from repro_torch.kernels.mlp_matmul import (mlp_matmul, mlp_matmul_split,
                                            mlp_matmul_stream, mlp_plain)
from repro_torch.kernels.rms_norm import rms_norm, rms_norm_plain

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=2e-4, atol=2e-4)


def _pair(shape, dtype, seed, scale=1.0):
    """The same values as a jax and a torch array (f32 -> dtype rounds
    to nearest even on both sides)."""
    a = np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32) * scale
    jd, td = DTYPES[dtype]
    return jnp.asarray(a, jd), torch.from_numpy(a).to(td)


def _check(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **_tol(dtype))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("m,n,k,bm,bn,bk", [(128, 128, 128, 128, 128, 128),
                                            (256, 512, 384, 128, 128, 128),
                                            (8, 256, 512, 8, 128, 256)])
def test_matmul_plain_matches_pallas(dtype, m, n, k, bm, bn, bk):
    ja, ta = _pair((m, k), dtype, 0)
    jb, tb = _pair((k, n), dtype, 1)
    want = matmul_pallas(ja, jb, bm=bm, bn=bn, bk=bk, interpret=True)
    _check(matmul_plain(ta, tb), want, dtype)
    _check(matmul(ta, tb), want, dtype)       # the wrapper, CPU tensors


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("m,d,bm", [(64, 256, 16), (256, 128, 256),
                                    (4, 96, 4)])
def test_rms_norm_plain_matches_pallas(dtype, m, d, bm):
    jx, tx = _pair((m, d), dtype, 2)
    jw, tw = _pair((d,), dtype, 3)
    want = rms_norm_pallas(jx, jw, 1e-6, bm=bm, interpret=True)
    _check(rms_norm_plain(tx, tw, 1e-6), want, dtype)
    _check(rms_norm(tx, tw, 1e-6), want, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("variant", ["flash", "blocked"])
def test_attention_plain_matches_pallas(dtype, causal, variant):
    jq, tq = _pair((1, 2, 128, 64), dtype, 4)
    jk, tk = _pair((1, 2, 128, 64), dtype, 5)
    jv, tv = _pair((1, 2, 128, 64), dtype, 6)
    if variant == "flash":
        want = flash_attention_pallas(jq, jk, jv, causal, bq=64, bkv=32,
                                      interpret=True)
        fn = flash_attention
    else:
        want = blocked_attention_pallas(jq, jk, jv, causal, bq=32,
                                        interpret=True)
        fn = blocked_attention
    _check(attention_plain(tq, tk, tv, causal), want, dtype)
    _check(fn(tq, tk, tv, causal), want, dtype)


def test_attention_plain_keeps_the_kernels_top_left_mask():
    """With sq != skv the Pallas kernels mask top-left (row >= col), the
    oracle bottom-right; the port holds to the kernels."""
    jq, tq = _pair((1, 2, 64, 32), "float32", 7)
    jk, tk = _pair((1, 2, 128, 32), "float32", 8)
    jv, tv = _pair((1, 2, 128, 32), "float32", 9)
    kern = flash_attention_pallas(jq, jk, jv, True, bq=32, bkv=32,
                                  interpret=True)
    _check(attention_plain(tq, tk, tv, True), kern, "float32")
    oracle = jref.attention_ref(jq, jk, jv, True)
    assert np.abs(np.asarray(oracle) - np.asarray(kern)).max() > 1e-2
    _check(tref.attention_ref(tq, tk, tv, True), oracle, "float32")


_MLP_PALLAS = {"fused": (mlp_matmul_fused_pallas, mlp_matmul),
               "stream": (mlp_matmul_stream_pallas, mlp_matmul_stream),
               "split": (mlp_matmul_split_pallas, mlp_matmul_split)}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("variant", list(_MLP_PALLAS))
def test_gated_mlp_plain_matches_pallas(dtype, act, variant):
    jx, tx = _pair((64, 128), dtype, 10)
    jg, tg = _pair((128, 256), dtype, 11, scale=128 ** -0.5)
    ju, tu = _pair((128, 256), dtype, 12, scale=128 ** -0.5)
    pallas, port = _MLP_PALLAS[variant]
    kw = dict(bm=32, bn=128) if variant == "stream" \
        else dict(bm=32, bn=128, bk=64)
    want = pallas(jx, jg, ju, act, interpret=True, **kw)
    _check(mlp_plain(tx, tg, tu, act), want, dtype)
    _check(port(tx, tg, tu, act), want, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_oracles_match_the_reference_oracles(dtype):
    ja, ta = _pair((16, 32), dtype, 13)
    jb, tb = _pair((32, 24), dtype, 14)
    _check(tref.matmul_ref(ta, tb), jref.matmul_ref(ja, jb), dtype)
    jw, tw = _pair((32,), dtype, 15)
    _check(tref.rms_norm_ref(ta, tw), jref.rms_norm_ref(ja, jw), dtype)
    jg, tg = _pair((32, 24), dtype, 16)
    for act in ("silu", "gelu", "relu"):
        _check(tref.mlp_matmul_ref(ta, tb, tg, act),
               jref.mlp_matmul_ref(ja, jb, jg, act), dtype)
    jq, tq = _pair((1, 2, 16, 8), dtype, 17)
    _check(tref.attention_ref(tq, tq, tq, True),
           jref.attention_ref(jq, jq, jq, True), dtype)


def test_cuda_launchers_refuse_cpu_tensors():
    """A CUDA wrapper takes CUDA tensors or raises; only the kernel's
    entry point routes CPU tensors to the plain version."""
    a = torch.ones(4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        matmul_cuda(a, a.T.contiguous(), tile="m16n16k64")
    q = torch.ones(1, 1, 4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        flash_cuda(q, q, q, True, tile="q16k32")


def test_kernel_modules_import_and_run_without_nvcc(monkeypatch):
    """Nothing is built at import; CPU tensors never reach the build."""
    monkeypatch.setattr(_cuda, "_lib", None)

    def no_build():
        raise AssertionError("the CPU path must not build the kernels")
    monkeypatch.setattr(_cuda, "library", no_build)
    x = torch.ones(4, 16)
    w = torch.ones(16)
    torch.testing.assert_close(ops.rms_norm(x, w), rms_norm_plain(x, w))
    wg = torch.ones(16, 8) / 16
    torch.testing.assert_close(ops.mlp_matmul(x, wg, wg, "gelu"),
                               mlp_plain(x, wg, wg, "gelu"))
