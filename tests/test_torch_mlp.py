"""B5, the gated MLP, on the CPU: its H100 tables, their pricing and
picks, and a model of the whole-D gated GEMV's summation.

* The gated and stream tables take the GEMM table's eight fields, each
  a SIMT family and a Hopper family (TMA + wgmma gated rows, whole-D
  gated GEMV stream rows), in the C tables' order.
* Every SIMT row keeps the predicted time it had before the Hopper
  rows were added, bit for bit (captured then, as hex).
* The gated wgmma rows are infeasible for float32 and for D or F not a
  multiple of 8; the stream GEMV rows where x's panel does not fit a
  block's shared memory.
* The analysis' picks at serving's four instances are deterministic and
  feasible: the stream GEMV rows at decode (m = 1, 4), the gated wgmma
  rows at prefill (m = 64, 256).
* A numpy model of `stream_gemv_kernel`'s split of D over lanes and
  warps and of its fixed summation order gives the plain version's
  result, the reference oracle's and the reference's stream Pallas
  kernel's (interpret mode), within tests/test_kernels.py's tolerances.
* gemma-smoke served through the entry point with ``--device cpu
  --tuned-ops --pretune --assert-frozen`` under the H100's picks gives
  the reference's greedy tokens.
"""
import contextvars
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels  # noqa: F401
import repro_torch.kernels  # noqa: F401  (registers every kernel)
from repro.configs import get_smoke as ref_get_smoke
from repro.distributed import make_serve_fns as ref_make_serve_fns
from repro.kernels.mlp_matmul import mlp_matmul_stream_pallas
from repro.kernels.ref import mlp_matmul_ref
from repro.models import Param as RefParam
from repro.models import build_model as ref_build_model
from repro.models.layers import use_tuned_layers as ref_use_tuned
from repro_torch import models
from repro_torch import tuning_cache as tc
from repro_torch.configs import get_smoke
from repro_torch.core import hw
from repro_torch.core.predict import static_times_batch
from repro_torch.core.target import use_target
from repro_torch.kernels import api
from repro_torch.kernels.matmul import GEMV, SIMT, WGMMA, tile_fields
from repro_torch.kernels.mlp_matmul import (GATED_TILES, SG_WARPS,
                                            STREAM_TILES, mlp_plain,
                                            stream_gemv_takes)
from repro_torch.tuning_cache.registry import _model_for

H100 = hw.H100_SXM
TABLES = {"fused": GATED_TILES, "stream": STREAM_TILES}
SERVE = [dict(m=m, d=3072, f=24576, act="gelu", dtype="bfloat16")
         for m in (1, 4, 64, 256)]


def _times(sig):
    """(rows, predicted seconds) of mlp_matmul's whole H100 space at
    ``sig``, ranked as dispatch ranks them."""
    spec = api.get_spec("mlp_matmul")
    pts = spec.hopper_space(**sig).enumerate()
    cols = {k: np.asarray([p[k] for p in pts]) for k in pts[0]}
    info = spec.hopper_info_batch(cols, H100, **sig)
    return pts, static_times_batch(None, _model_for(H100), F=info.F,
                                   pipe=info.pipe, feasible=info.feasible)


@pytest.mark.parametrize("variant", ["fused", "stream"])
def test_the_tables_take_the_gemm_tables_fields(variant):
    table = TABLES[variant]
    t = tile_fields(table, list(table))
    assert t.shape == (len(table), 8)
    fam = t[:, 5]
    hopper = WGMMA if variant == "fused" else GEMV
    assert set(fam) == {SIMT, hopper}
    assert list(fam) == sorted(fam)       # the C side's indices run on
    assert (t[fam == SIMT][:, 6:] == 1).all()
    assert (t[:, 7] == 1).all()           # no row splits the contraction
    if variant == "fused":
        assert (t[fam == WGMMA][:, [0, 2]] == (128, 64)).all()
        assert set(t[fam == WGMMA][:, 6]) == {3, 4}
    else:
        assert (t[:, 2] == 0).all()       # the whole of D in one block
        assert set(t[fam == GEMV][:, 0]) == {1, 4, 8}
        assert set(t[fam == GEMV][:, 1]) == {64, 128}


# mlp_matmul's SIMT rows (fused, stream) at each signature: their
# predicted seconds before the Hopper rows joined the tables
PARENT_PRICES = [
    ({'m': 1, 'd': 3072, 'f': 24576, 'act': 'gelu', 'dtype': 'bfloat16'}, {
        'fused/m16n64k32': '0x1.2be33059d6246p-11',
        'fused/m32n64k32': '0x1.45eae54cf9b70p-11',
        'fused/m64n64k16': '0x1.79fa4f3340dc7p-11',
        'fused/m128n64k16': '0x1.f00cb5a6218bbp-10',
        'fused/m64n128k16': '0x1.e77562074df0ap-11',
        'fused/m16n32k64': '0x1.eaa9d451bc77ap-12',
        'fused/m16n16k64': '0x1.25f5abb5fbd92p-11',
        'stream/m4n4': '0x1.4277a00a034f0p-9',
        'stream/m8n8': '0x1.60c32e037e500p-8',
        'stream/m16n16': 'inf',
        'stream/m32n32': 'inf',
    }),
    ({'m': 4, 'd': 3072, 'f': 24576, 'act': 'gelu', 'dtype': 'bfloat16'}, {
        'fused/m16n64k32': '0x1.2d652aabcda12p-11',
        'fused/m32n64k32': '0x1.476cdf9ef133cp-11',
        'fused/m64n64k16': '0x1.7b7c498538593p-11',
        'fused/m128n64k16': '0x1.f19abfcaa8c45p-10',
        'fused/m64n128k16': '0x1.e89cc62be9626p-11',
        'fused/m16n32k64': '0x1.ef23f2795f458p-12',
        'fused/m16n16k64': '0x1.2a8d832480da9p-11',
        'stream/m4n4': '0x1.734531fcb6f2bp-9',
        'stream/m8n8': '0x1.73165c68dc903p-8',
        'stream/m16n16': 'inf',
        'stream/m32n32': 'inf',
    }),
    ({'m': 64, 'd': 3072, 'f': 24576, 'act': 'gelu', 'dtype': 'bfloat16'}, {
        'fused/m16n64k32': '0x1.27b720fa1e14bp-9',
        'fused/m32n64k32': '0x1.5f0e197f2ab96p-10',
        'fused/m64n64k16': '0x1.99a3d7ec8e182p-11',
        'fused/m128n64k16': '0x1.0859c5529c98ap-9',
        'fused/m64n128k16': '0x1.ffb099080e457p-11',
        'fused/m16n32k64': '0x1.06e6f909a3243p-9',
        'fused/m16n16k64': '0x1.3b5a39a783d22p-9',
        'stream/m4n4': '0x1.68a424e3c3c56p-5',
        'stream/m8n8': '0x1.80ff7e2633060p-5',
        'stream/m16n16': 'inf',
        'stream/m32n32': 'inf',
    }),
    ({'m': 256, 'd': 3072, 'f': 24576, 'act': 'gelu', 'dtype': 'bfloat16'}, {
        'fused/m16n64k32': '0x1.ec3f4b44562b2p-8',
        'fused/m32n64k32': '0x1.06c45b625a5b9p-8',
        'fused/m64n64k16': '0x1.a4cd887d40c4bp-9',
        'fused/m128n64k16': '0x1.a5242e65db979p-9',
        'fused/m64n128k16': '0x1.070557d0ce79bp-8',
        'fused/m16n32k64': '0x1.06824f3bdee0ap-7',
        'fused/m16n16k64': '0x1.3af58fd9bf8e9p-7',
        'stream/m4n4': '0x1.6787cb0b37bc4p-3',
        'stream/m8n8': '0x1.7f6df160453fcp-3',
        'stream/m16n16': 'inf',
        'stream/m32n32': 'inf',
    }),
    ({'m': 4, 'd': 3072, 'f': 24576, 'act': 'gelu', 'dtype': 'float32'}, {
        'fused/m16n64k32': '0x1.758579bc7c9b8p-11',
        'fused/m32n64k32': '0x1.90571ce589fc6p-11',
        'fused/m64n64k16': '0x1.c5fa6337a4be0p-11',
        'fused/m128n64k16': '0x1.20d6e074867f5p-9',
        'fused/m64n128k16': '0x1.2a410426acc16p-10',
        'fused/m16n32k64': '0x1.2fbbc0fa1745ap-11',
        'fused/m16n16k64': '0x1.68bccac8aacf3p-11',
        'stream/m4n4': '0x1.adf8182d79084p-7',
        'stream/m8n8': 'inf',
        'stream/m16n16': 'inf',
        'stream/m32n32': 'inf',
    }),
    ({'m': 5, 'd': 200, 'f': 300, 'act': 'silu', 'dtype': 'float32'}, {
        'fused/m16n64k32': '0x1.ac785027fc6eep-15',
        'fused/m32n64k32': '0x1.c97b91d6fc150p-15',
        'fused/m64n64k16': '0x1.00f0ccf2e4941p-14',
        'fused/m128n64k16': '0x1.3ab1e66e5b81ap-14',
        'fused/m64n128k16': '0x1.9f4965b8dd4e4p-14',
        'fused/m16n32k64': '0x1.f30984442ec37p-16',
        'fused/m16n16k64': '0x1.410701f2c9574p-16',
        'stream/m4n4': '0x1.c4a704f693346p-17',
        'stream/m8n8': '0x1.abb7cc27b9564p-16',
        'stream/m16n16': '0x1.3e2e2a2831734p-16',
        'stream/m32n32': '0x1.13f495e90782bp-15',
    }),
    ({'m': 130, 'd': 96, 'f': 72, 'act': 'relu', 'dtype': 'bfloat16'}, {
        'fused/m16n64k32': '0x1.6356c81bcf495p-16',
        'fused/m32n64k32': '0x1.863fd788f5ef8p-16',
        'fused/m64n64k16': '0x1.c80967fa0e406p-16',
        'fused/m128n64k16': '0x1.2144a437c3d63p-15',
        'fused/m64n128k16': '0x1.65cb837b8141cp-15',
        'fused/m16n32k64': '0x1.d8701cce3ade4p-17',
        'fused/m16n16k64': '0x1.5704434ee519cp-17',
        'stream/m4n4': '0x1.2dc5b4fbb68fcp-17',
        'stream/m8n8': '0x1.1f8d29fd378d0p-17',
        'stream/m16n16': '0x1.5563c7ffb2e0ap-17',
        'stream/m32n32': '0x1.0d0a4f9a4ac77p-16',
    }),
]


@pytest.mark.parametrize("sig,parent", PARENT_PRICES,
                         ids=[f"m{s['m']}-d{s['d']}-f{s['f']}-{s['dtype']}"
                              for s, _ in PARENT_PRICES])
def test_the_simt_rows_keep_their_prices_bit_for_bit(sig, parent):
    pts, now = _times(sig)
    got = {f"{p['variant']}/{p['tile']}": v for p, v in zip(pts, now)}
    assert set(parent) <= set(got)
    for row, hexed in parent.items():
        assert got[row] == float.fromhex(hexed), row


@pytest.mark.parametrize("dtype,d,f,takes", [
    ("bfloat16", 3072, 24576, True), ("float32", 3072, 24576, False),
    ("bfloat16", 3070, 24576, False), ("bfloat16", 3072, 24570, False),
    ("bfloat16", 96, 72, True), ("float32", 96, 72, False)])
def test_gated_wgmma_rows_are_feasible_only_where_they_launch(dtype, d, f,
                                                              takes):
    pts, t = _times(dict(m=64, d=d, f=f, act="silu", dtype=dtype))
    for p, v in zip(pts, t):
        if p["variant"] == "fused" and GATED_TILES[p["tile"]][5] == WGMMA:
            assert np.isfinite(v) == takes, (p, v)
        elif p["variant"] == "fused":
            assert np.isfinite(v), p      # the SIMT rows take any shape


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [3072, 24576, 65536])
def test_stream_gemv_rows_are_feasible_where_x_panel_fits(dtype, d):
    """x's (BM, D) panel and the sums in one block's 227 KB."""
    pts, t = _times(dict(m=4, d=d, f=512, act="gelu", dtype=dtype))
    for p, v in zip(pts, t):
        if p["variant"] == "stream" and STREAM_TILES[p["tile"]][5] == GEMV:
            fits = stream_gemv_takes(p["tile"], d, dtype)
            bm, bn = STREAM_TILES[p["tile"]][:2]
            eb = 4 if dtype == "float32" else 2
            assert fits == (bm * d * eb + 2 * bm * bn * 4 + 16
                            <= H100.shmem_per_block)
            assert np.isfinite(v) == fits, (p, v)


@pytest.mark.parametrize("sig", SERVE, ids=[f"m{s['m']}" for s in SERVE])
def test_the_picks_at_servings_instances(sig):
    """Deterministic, feasible, and of the family the design meant:
    the whole-D GEMV at decode, the TMA + wgmma tile at prefill."""
    picks = [tc.lookup_or_tune("mlp_matmul", spec="h100",
                               db=tc.TuningDatabase(), **sig)
             for _ in range(2)]
    assert picks[0] == picks[1]
    p = picks[0]
    pts, t = _times(sig)
    row = [v for q, v in zip(pts, t)
           if (q["variant"], q["tile"]) == (p["variant"], p["tile"])]
    assert len(row) == 1 and np.isfinite(row[0])
    assert row[0] == np.min(t)
    fam = TABLES[p["variant"]][p["tile"]][5] \
        if p["variant"] in TABLES else None
    if sig["m"] <= 4:
        assert (p["variant"], fam) == ("stream", GEMV), p
    else:
        assert (p["variant"], fam) == ("fused", WGMMA), p


def stream_gemv_model(x, wg, wu, act, tile, eb):
    """float32 numpy model of `stream_gemv_kernel` (csrc/gemm.cu): a
    block of BN columns and BM rows; warps 0-3 read W_gate and 4-7 W_up;
    a lane owns 16 bytes (16 / eb columns) of a row, BN / (16 / eb)
    lanes span the block's row, and chunk c (rows c R .. c R + R - 1 of
    D, R the row's STAGES) goes to warp (c mod 4 RW) // RW of each half,
    row slot c mod RW; each thread adds its chunks' rows in order (a
    product then a sum, where the kernel fuses them), the row slots meet
    in the warp's xor butterfly, a half's warps in warp order, and the
    activation and gating run once on the two halves' sums."""
    bm, bn, r = (STREAM_TILES[tile][i] for i in (0, 1, 6))
    lanes = bn // (16 // eb)
    rw, wh = 32 // lanes, SG_WARPS // 2
    m, d = x.shape
    f = wg.shape[1]
    out = np.zeros((m, f), np.float32)
    for row0 in range(0, m, bm):
        xs = np.zeros((bm, d), np.float32)
        xs[:min(bm, m - row0)] = x[row0:row0 + bm]
        for col0 in range(0, f, bn):
            sums = []
            for w in (wg, wu):
                b = w[:, col0:col0 + bn]
                part = np.zeros((wh, rw, bm, b.shape[1]), np.float32)
                for c in range(-(-d // r)):
                    warp, slot = (c % (wh * rw)) // rw, c % rw
                    for k in range(c * r, min(c * r + r, d)):
                        part[warp, slot] = (part[warp, slot]
                                            + xs[:, k:k + 1] * b[k])
                o = 1
                while o < rw:            # xor butterfly over the row slots
                    part = part + part[:, np.arange(rw) ^ o]
                    o *= 2
                acc = part[0, 0]
                for k in range(1, wh):   # warp order
                    acc = acc + part[k, 0]
                sums.append(acc)
            gate = torch.from_numpy(sums[0])
            h = {"silu": torch.nn.functional.silu,
                 "gelu": lambda t: torch.nn.functional.gelu(
                     t, approximate="tanh"),
                 "relu": torch.relu}[act](gate).numpy() * sums[1]
            out[row0:row0 + bm, col0:col0 + bn] = h[:min(bm, m - row0)]
    return out


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=2e-4, atol=2e-4)


STREAM_GEMV_ROWS = [t for t, f in STREAM_TILES.items() if f[5] == GEMV]
# (M, D, F, act): M = 1, 4 and 5 (over and under BM), D not a whole
# number of chunks of any row's 8 or 16 rows, F ragged against both BN
MODEL_CASES = [(1, 100, 72, "silu"), (4, 203, 130, "gelu"),
               (5, 98, 70, "relu")]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", MODEL_CASES,
                         ids=["x".join(map(str, c)) for c in MODEL_CASES])
@pytest.mark.parametrize("tile", STREAM_GEMV_ROWS)
def test_stream_gemv_model_computes_the_plain_and_the_reference(
        tile, case, dtype):
    m, d, f, act = case
    rng = np.random.default_rng(m * 1000 + d)
    tdt, jdt = {"float32": (torch.float32, jnp.float32),
                "bfloat16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    arrs = [rng.standard_normal((m, d)).astype(np.float32),
            (rng.standard_normal((d, f)) * d ** -0.5).astype(np.float32),
            (rng.standard_normal((d, f)) * d ** -0.5).astype(np.float32)]
    tx, tg, tu = (torch.from_numpy(a).to(tdt) for a in arrs)
    # the kernel reads the operands in their own type, widened exactly
    x, wg, wu = (t.float().numpy() for t in (tx, tg, tu))
    got = torch.from_numpy(stream_gemv_model(
        x, wg, wu, act, tile, 2 if dtype == "bfloat16" else 4)).to(tdt)
    torch.testing.assert_close(got.float(), mlp_plain(tx, tg, tu, act)
                               .float(), **_tol(dtype))
    jx, jg, ju = (jnp.asarray(a).astype(jdt) for a in arrs)
    for want in (mlp_matmul_ref(jx, jg, ju, act),
                 mlp_matmul_stream_pallas(jx, jg, ju, act, bm=m, bn=f,
                                          interpret=True)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   **_tol(dtype))


class _Loaded:
    """A port model whose parameters are given (the reference's, through
    numpy), for the serve entry point; the meta-device init of the graph
    pretune stays the model's own."""

    def __init__(self, model, params):
        self._model, self._params = model, params

    def __getattr__(self, name):
        return getattr(self._model, name)

    def init(self, *, seed: int = 0, device=None):
        if str(device) == "meta":
            return self._model.init(seed=seed, device=device)
        return self._params


def test_gemma_smoke_serves_the_reference_tokens_under_the_h100_picks(
        monkeypatch):
    """The serve entry point with ``--device cpu --tuned-ops --pretune
    --assert-frozen``, its dispatch ranked for the H100 (the gated MLP
    on its new picks, each wrapper running its plain version on CPU
    tensors), gives the reference's greedy tokens from the reference's
    weights in float32, and passes its frozen-dispatch gate."""
    from repro_torch.launch import serve
    from repro_torch.models import from_numpy_tree
    batch, plen, gen = 2, 16, 8
    ref_cfg = dataclasses.replace(ref_get_smoke("gemma-7b"), dtype="float32")
    cfg = dataclasses.replace(get_smoke("gemma-7b"), dtype="float32")
    g = torch.Generator(device="cpu")
    g.manual_seed(0)                      # serve's own prompt, seed 0
    prompt = torch.randint(0, cfg.vocab, (batch, plen), generator=g)
    ref_model = ref_build_model(ref_cfg)
    params = ref_model.init(jax.random.PRNGKey(0))
    prefill, decode = ref_make_serve_fns(ref_model)
    with ref_use_tuned():
        logits, cache = jax.jit(prefill)(
            params, {"tokens": jnp.asarray(prompt.numpy(), jnp.int32)})
        step = jax.jit(decode)
        tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
        out = [tok]
        for _ in range(gen):
            logits, cache = step(params, cache, tok)
            tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
            out.append(tok)
    ref_toks = np.concatenate([np.asarray(t) for t in out], axis=1)
    tree = jax.tree.map(lambda p: (np.asarray(p.value), p.dims), params,
                        is_leaf=lambda x: isinstance(x, RefParam))
    loaded = from_numpy_tree(tree, dtype=torch.float32, device="cpu")
    real = models.build_model
    monkeypatch.setattr(models, "build_model",
                        lambda c: _Loaded(real(c), loaded))

    def run():
        with use_target("h100"):
            return serve.main(["--arch", "gemma-7b", "--smoke", "--device",
                               "cpu", "--tuned-ops", "--pretune",
                               "--assert-frozen", "--batch", str(batch),
                               "--prompt-len", str(plen), "--gen",
                               str(gen)], cfg=cfg)
    tc.set_default_db(tc.TuningDatabase())
    try:
        # the entry point turns tuned layers on for its context: run it
        # in a copy so the switch does not outlive the test
        rep = contextvars.copy_context().run(run)
    finally:
        tc.thaw()
        tc.reset_default_db()
    picks = [i["params"] for i in rep["instances"]
             if i["kernel"] == "mlp_matmul"]
    assert picks and all(p["variant"] in ("fused", "stream", "split")
                         for p in picks)
    np.testing.assert_array_equal(np.asarray(rep["tokens"]), ref_toks)
