"""The port's int8 error-feedback pod-gradient compression against the
reference's (``distributed/compression.py``).

* `quantize_int8` / `dequantize_int8` on one device: bit for bit.
* `ef_compress_grads` on a (2, 1, 2) ``pod`` x ``data`` x ``model``
  mesh — the port in a spawned 4-rank gloo world with gradients laid out
  over ``model`` (sharded along either dim) or replicated, the reference
  in a subprocess on 4 host devices with an Auto-axis mesh: the
  compressed gradient and the residual, over two calls with the residual
  carried, bit for bit.  The reference's gradients arrive replicated, so
  its ``g_hat = q_sum * (scale_sum / n) / n`` is the dequantised ``q``
  rounded through that formula; the port computes it in that order.
* gemma-smoke's meshed train step with ``compress_pod_grads``, float32,
  microbatches 1, two AdamW steps: loss and grad norm within 1e-5
  relative, parameters within 1e-4 of the reference's compressed steps.
  (Rounding to int8 is a step function: a gradient that differs from
  the reference's in its last bit can land one quantum away, which AdamW
  turns into a parameter step of ~1e-4.  With two microbatches one
  element of 16384 in ``wk`` does so, 1.7e-4 off after two steps; the
  uncompressed two-microbatch step is `test_torch_mesh.py`'s.)
  The reference's ``adamw_update`` builds a fresh state without
  ``"ef"``, so every step compresses with a zero residual; the port's
  step drops the residual likewise (held here: no ``"ef"`` in the state
  a step returns).
"""
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_worlds as worlds
from repro.distributed import compression as ref_compression
from repro_torch.distributed import compression
from repro_torch.launch.mesh import spawn_world

SHAPES = {"a": (8, 12), "b": (5, 3), "c": (6, 4, 2)}
CALLS = 2

_REF = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro.distributed.compression import ef_compress_grads
mesh = jax.make_mesh((2, 1, 2), ("pod", "data", "model"),
                     axis_types=(AxisType.Auto,) * 3)
with np.load(sys.argv[1]) as f:
    grads = {k: f[k] for k in f.files}
step = jax.jit(lambda g, o: ef_compress_grads(g, o, mesh))
opt, out = {}, {}
for s in range(int(sys.argv[3])):
    g, opt = step({k: jnp.asarray(v[s]) for k, v in grads.items()}, opt)
    for k in grads:
        out[f"g{s}{k}"] = np.asarray(g[k])
        out[f"r{s}{k}"] = np.asarray(opt["ef"]["residual"][k])
np.savez(sys.argv[2], **out)
"""


def _grads():
    rng = np.random.default_rng(0)
    return {k: (rng.standard_normal((CALLS,) + s) * 10.0 ** -i).astype(
        np.float32) for i, (k, s) in enumerate(SHAPES.items())}


@pytest.mark.parametrize("scale", [1.0, 1e-3, 0.0])
def test_quantize_and_dequantize_match_the_reference_bit_for_bit(scale):
    x = (np.random.default_rng(1).standard_normal((33, 7)) * scale).astype(
        np.float32)
    rq, rs = ref_compression.quantize_int8(jnp.asarray(x))
    q, s = compression.quantize_int8(torch.from_numpy(x))
    assert np.array_equal(q.numpy(), np.asarray(rq))
    assert np.array_equal(s.numpy(), np.asarray(rs))
    assert np.array_equal(compression.dequantize_int8(q, s).numpy(),
                          np.asarray(ref_compression.dequantize_int8(rq,
                                                                     rs)))


@pytest.fixture(scope="module")
def compressed(tmp_path_factory):
    d = tmp_path_factory.mktemp("ef")
    grads = _grads()
    np.savez(d / "grads.npz", **grads)
    env = dict(os.environ, PYTHONPATH=os.path.join(worlds.REPO, "src"),
               JAX_PLATFORMS="cpu")
    ref = subprocess.Popen([sys.executable, "-c", _REF, str(d / "grads.npz"),
                            str(d / "ref.npz"), str(CALLS)], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    try:
        port = spawn_world(worlds.compression_case, 4, grads, CALLS,
                           timeout=worlds.WORLD_TIMEOUT)
        _, err = ref.communicate(timeout=worlds.WORLD_TIMEOUT)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, err[-3000:]
    with np.load(d / "ref.npz") as f:
        want = {k: f[k] for k in f.files}
    return port, want


@pytest.mark.parametrize("call", range(CALLS))
@pytest.mark.parametrize("leaf", list(SHAPES))
def test_ef_compress_grads_matches_the_reference_bit_for_bit(compressed,
                                                             leaf, call):
    port, want = compressed
    for rank_out in port:               # every rank holds the same
        g = rank_out[call]["g"][leaf]
        r = rank_out[call]["r"][leaf]
        assert g.dtype == np.float32 and g.shape == SHAPES[leaf]
        assert np.array_equal(g, want[f"g{call}{leaf}"])
        assert np.array_equal(r, want[f"r{call}{leaf}"])
    # the residual is the quantisation error, not zero
    assert np.abs(want[f"r{call}{leaf}"]).max() > 0


CASES = [dict(arch="gemma-7b", dtype="float32", mb=1, compress=True)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return worlds.run_train_cases(str(tmp_path_factory.mktemp("step")),
                                  CASES)


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[worlds.case_id(c) for c in CASES])
def test_a_compressed_meshed_train_step_matches_the_reference(runs, i):
    (ref_metrics, ref_final), port = runs[i]
    worlds.assert_case_matches(CASES[i], ref_metrics, ref_final, port)
    assert port["residual"] is None     # dropped, as the reference's
