"""The optimizer's kernel route (`repro_torch.optim.adamw`,
``kernels/csrc/optim.cu``) on the CPU, where the kernels cannot run.

* CPU leaves take the plain route: `adamw_update` equals
  `adamw_update_plain` bit for bit and launches nothing;
* no fallback: with the kernel library made to raise, leaves that take
  the kernel route raise that error and nothing is updated;
* the kernels' per-element arithmetic, modelled in numpy float32 with
  the kernel's roundings (each product, sum, quotient and square root
  rounded once; ``add_(x, alpha=)`` an fma), equals `leaf_update_plain`
  on the CPU: m and v bit for bit, p within one ulp (whether the CPU's
  own ``add_`` contracts is its vector library's choice);
* on ``meta`` (a dry-run's trace) both custom ops allocate nothing but
  the norm's scalar, and a traced train step holds no update temporary
  at its peak: one ``sumsq`` and one ``adamw_`` a leaf;
* on a (2, 2) gloo mesh the kernel route, its ops stood in for by the
  plain arithmetic, hands each op whole contiguous local shards and
  gives the plain route's losses, grad norms and parameters bit for
  bit: gemma-7b's, qwen2-moe-a2.7b's (experts sharded over model),
  hymba-1.5b's and mamba2-1.3b's (SSD blocks) smoke configs;
* the C interface: ``optim.cu`` is a library source and its exported
  functions take the arguments `_cuda` binds.
"""
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import _cuda
from repro_torch.models import Param
from repro_torch.models.params import tree_leaves
from repro_torch.optim import adamw
from repro_torch.optim.adamw import (AdamWConfig, adamw_update,
                                     adamw_update_plain, init_adamw)

CFG = AdamWConfig(peak_lr=1e-2, warmup_steps=10, decay_steps=100)
SHAPES = {"w": {"z": (8, 16), "a": (16,)}, "b": (4, 3, 5), "emb": (32, 8)}


def tree(seed, scale=1.0, dtype=torch.float32):
    rng = np.random.default_rng(seed)

    def make(node):
        if isinstance(node, dict):
            return {k: make(v) for k, v in node.items()}
        a = (rng.standard_normal(node) * scale).astype(np.float32)
        return Param(torch.from_numpy(a).to(dtype),
                     tuple(f"d{i}" for i in range(len(node))))
    return make(SHAPES)


def values(t):
    return [leaf.value.clone() for _, leaf in tree_leaves(t)]


@pytest.mark.parametrize("steps", [1, 3])
def test_cpu_leaves_take_the_plain_route(steps):
    p1, p2 = tree(0), tree(0)
    o1, o2 = init_adamw(p1), init_adamw(p2)
    before = dict(adamw.LAUNCHES)
    assert not adamw.on_card(p1)
    for s in range(steps):
        g1, g2 = tree(10 + s, 10.0), tree(10 + s, 10.0)
        p1, o1, m1 = adamw_update(p1, g1, o1, CFG)
        p2, o2, m2 = adamw_update_plain(p2, g2, o2, CFG)
        assert torch.equal(m1["grad_norm"], m2["grad_norm"])
    for a, b in zip(values(p1) + values(o1["m"]) + values(o1["v"]),
                    values(p2) + values(o2["m"]) + values(o2["v"])):
        assert torch.equal(a, b)
    assert adamw.LAUNCHES == before


def test_meta_leaves_take_the_kernel_route():
    p = {"w": torch.empty(4, device="meta")}
    assert adamw.on_card(p)


def _no_library():
    raise RuntimeError("planted: the kernel library did not build")


@pytest.mark.parametrize("what", ["update", "norm"])
def test_a_failed_build_raises_and_nothing_falls_back(monkeypatch, what):
    monkeypatch.setattr(adamw, "on_card", lambda t: True)
    monkeypatch.setattr(_cuda, "library", _no_library)
    params, grads = tree(0), tree(1)
    state = init_adamw(params)
    want = values(params) + values(state["m"]) + values(state["v"])
    before = dict(adamw.LAUNCHES)
    with pytest.raises(RuntimeError, match="planted"):
        if what == "update":
            adamw_update(params, grads, state, CFG)
        else:
            adamw.global_norm(grads)
    got = values(params) + values(state["m"]) + values(state["v"])
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert int(state["count"]) == 0 and adamw.LAUNCHES == before


def test_the_custom_ops_refuse_cpu_tensors_once_built(monkeypatch):
    """Past the build, a CPU operand is refused, never computed."""
    monkeypatch.setattr(_cuda, "library", lambda: None)
    x = torch.ones(8)
    with pytest.raises(ValueError, match="CUDA"):
        adamw.sumsq(x)
    with pytest.raises(ValueError, match="CUDA"):
        adamw.adamw_leaf(x, x, x, x, torch.ones(4), 0.9, 0.95, 1e-8, 0.1)
    assert torch.equal(x, torch.ones(8))


def _f32(x):
    return np.float32(x)


def _fma(a, b, c):
    # a * b is exact in float64 (24-bit significands); one rounding of
    # the sum to float32 stands in for the fma's
    return (a.astype(np.float64) * b + c).astype(np.float32)


def kernel_model(p, g, m, v, clip, lr, bc1, bc2, cfg):
    """csrc/optim.cu `AdamW::operator()` in numpy float32."""
    b1, b2 = _f32(cfg.b1), _f32(cfg.b2)
    omb1, omb2 = _f32(1 - cfg.b1), _f32(1 - cfg.b2)
    gc = g * clip
    m = m * b1 + gc * omb1
    v = v * b2 + (gc * omb2) * gc
    den = np.sqrt(v / bc2) + _f32(cfg.eps)
    step = (m / bc1) / den
    step = _fma(p, _f32(cfg.weight_decay), step)
    return p - lr * step, m, v


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_the_kernel_arithmetic_is_the_plain_version_s(seed):
    rng = np.random.default_rng(seed)
    n = 4099
    p = rng.standard_normal(n).astype(np.float32)
    g = (rng.standard_normal(n) * 1e-2).astype(np.float32)
    m = (rng.standard_normal(n) * 1e-3).astype(np.float32)
    v = ((rng.standard_normal(n) * 1e-3) ** 2).astype(np.float32)
    clip, lr, bc1, bc2 = (np.float32(x) for x in (0.37, 3e-4, 0.271, 0.1426))
    want = kernel_model(p, g, m, v, clip, lr, bc1, bc2, CFG)
    tp, tm, tv = (torch.from_numpy(x.copy()) for x in (p, m, v))
    adamw.leaf_update_plain(tp, torch.from_numpy(g.copy()), tm, tv,
                            *(torch.tensor(x) for x in (clip, lr, bc1, bc2)),
                            CFG)
    np.testing.assert_array_equal(tm.numpy(), want[1])
    np.testing.assert_array_equal(tv.numpy(), want[2])
    ulps = np.abs(tp.numpy().view(np.int32).astype(np.int64)
                  - want[0].view(np.int32))
    assert ulps.max() <= 1


def test_the_ops_on_meta_allocate_nothing():
    from repro_torch.core.mix import live_bytes, trace_meta_fn
    x = torch.empty(1 << 20, device="meta")
    scal = torch.empty(4, device="meta")
    with live_bytes() as lb:
        graph = trace_meta_fn(lambda: (
            adamw.adamw_leaf(x, x, x, x, scal, 0.9, 0.95, 1e-8, 0.1),
            adamw.sumsq(x)))
    assert [op.name for op in graph.ops] == ["adamw_", "sumsq"]
    assert lb.peak == 4


# the plain update's elementwise ops (its casts of f32 leaves are no-ops)
UPDATE_OPS = {"mul", "div", "sqrt", "add", "sub", "square"}


@pytest.mark.parametrize("arch", ["whisper-tiny", "qwen2-moe-a2.7b",
                                  "gemma-7b"])
def test_a_traced_train_step_holds_no_update_temporary(monkeypatch, arch):
    """`launch.dryrun.lower_train_step` prices the step the card runs:
    one `sumsq` and one `adamw_` a leaf, and no storage alive at the
    peak that an update op made in a parameter's shape (before the
    kernels, whisper-tiny's and qwen2-moe's smoke peaks held the plain
    update's float32 products)."""
    import repro_torch.core.mix as mix
    from repro_torch.configs import get_smoke
    from repro_torch.launch import dryrun
    from repro_torch.models import build_model

    cfg = get_smoke(arch)
    leaves = [leaf.value for _, leaf in
              tree_leaves(build_model(cfg).abstract_params())]
    shapes = {tuple(x.shape) for x in leaves}
    ops = []

    def recording(fn, *a, **k):
        graph = traced(fn, *a, **k)
        ops.extend(op.name for op in graph.ops)
        return graph
    traced = mix.trace_meta_fn
    monkeypatch.setattr(mix, "trace_meta_fn", recording)
    low = dryrun.lower_train_step(cfg, 2, 16, top=10)
    held = [st for st in low.peak_storages
            if st["op"] in UPDATE_OPS and tuple(st["shape"]) in shapes
            and st["dtype"] == "float32"]
    assert held == []
    assert ops.count("sumsq") == ops.count("adamw_") == len(leaves)


def _c_args(name):
    src = (_cuda.CSRC / "optim.cu").read_text()
    m = re.search(rf"\bint {name}\(([^)]*)\)", src)
    assert m, name
    return [a for a in m.group(1).split(",") if a.strip()]


def test_the_c_interface_matches_its_binding():
    assert "optim.cu" in _cuda.SOURCES
    for name in ("repro_sumsq", "repro_adamw"):
        assert len(_c_args(name)) == len(_cuda._SIGNATURES[name]), name


@pytest.mark.parametrize("arch", ["gemma-7b", "qwen2-moe-a2.7b",
                                  "hymba-1.5b", "mamba2-1.3b"])
def test_the_kernel_route_on_a_mesh_takes_whole_local_shards(arch):
    import torch_mesh_worlds as worlds
    from repro_torch.launch.mesh import spawn_world
    r = spawn_world(worlds.optimizer_routes, 4, (2, 2), arch,
                    timeout=300)[0]
    # beyond gemma's layouts: leaves whole over data, sharded over model
    # (qwen2-moe's attention biases, the SSD blocks' conv and norm
    # weights), whose sum of squares is replicated over one mesh dim and
    # partial over the other; qwen2-moe's experts lie over model
    assert arch == "gemma-7b" or "(Replicate(), Shard(dim=1))" in \
        r["placements"]
    assert r["kernels"]["steps"] == r["plain"]["steps"]
    for k, v in r["plain"]["params"].items():
        np.testing.assert_array_equal(r["kernels"]["params"][k], v,
                                      err_msg=k)
    assert r["calls"] == {"sumsq": 2 * r["leaves"], "adamw": 2 * r["leaves"]}
