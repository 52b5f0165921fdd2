"""Shared machinery of the port's mesh tests.

Rank functions run in every rank of a world spawned by
`repro_torch.launch.mesh.spawn_world` (gloo, CPU) and return plain numpy
data; they import neither JAX nor the reference.  `run_train_cases`
runs a list of meshed train-step cases in the port's worlds and in the
reference (a subprocess on 4 host devices, a (2, 1, 2) mesh with Auto
axes or the case's own) side by side, from the reference's initial
parameters."""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD_TIMEOUT = 120
MESH_AXES = ("pod", "data", "model")
OPT = dict(peak_lr=1e-3, warmup_steps=2, decay_steps=50)
BATCH, SEQ, STEPS = 4, 32, 2


def load_params(model, npz_path):
    """The reference's initial parameters (saved by key string) in the
    port's tree, f32 masters on the CPU."""
    from repro_torch.models import from_numpy_tree
    from repro_torch.models.params import Param, tree_leaves
    tmpl = model.abstract_params()
    with np.load(npz_path) as npz:
        flat = {key: npz[key] for key in npz.files}

    def fill(node, path):
        if isinstance(node, Param):
            key = "".join(f"[{k!r}]" for k in path) + "[<flat index 0>]"
            return (flat[key], node.dims)
        return {k: fill(v, path + (k,)) for k, v in node.items()}
    return from_numpy_tree(fill(tmpl, ()), device="cpu")


def host_tree(params):
    """{key string: numpy array} of a Param tree, DTensors gathered."""
    from repro_torch.models.params import tree_leaves
    out = {}
    for path, leaf in tree_leaves(params):
        v = leaf.value
        if hasattr(v, "full_tensor"):
            v = v.full_tensor()
        out["".join(f"[{k!r}]" for k in path)] = v.detach().float().numpy()
    return out


def case_mesh(case):
    """(shape, axis names) of a case's mesh: ``case["mesh"]`` as
    [shape, axes], by default (2, 1, 2) over ``MESH_AXES``."""
    shape, axes = case.get("mesh", ((2, 1, 2), MESH_AXES))
    return tuple(shape), tuple(axes)


def case_config(case, get_smoke):
    """A case's smoke config: its compute type, and ``case["dispatch"]``
    as the MoE dispatch where given."""
    cfg = dataclasses.replace(get_smoke(case["arch"]), dtype=case["dtype"])
    if "dispatch" in case:
        cfg = dataclasses.replace(cfg, moe_dispatch=case["dispatch"])
    return cfg


def frames(cfg, step):
    """An encoder-decoder's stub frames for ``step`` (float32, seeded by
    the step), None for a token-only config."""
    if cfg.frontend != "frames":
        return None
    return np.random.default_rng(1000 + step).standard_normal(
        (BATCH, cfg.enc_seq, cfg.d_model)).astype(np.float32)


def train_case(rank, world, case, npz_path):
    """Meshed train steps of one case: {"metrics": [...], "params":
    {...}} after ``STEPS`` steps."""
    from repro_torch.configs import get_smoke
    from repro_torch.data import DataConfig, TokenStream
    from repro_torch.distributed import TrainStepConfig, make_train_step
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model, device_put, param_shardings
    from repro_torch.optim import AdamWConfig, init_adamw

    mesh = make_mesh(*case_mesh(case))
    cfg = case_config(case, get_smoke)
    model = build_model(cfg)
    params = load_params(model, npz_path)
    params = device_put(params, param_shardings(params, mesh))
    opt = init_adamw(params)
    step = make_train_step(
        model, AdamWConfig(**OPT), mesh=mesh,
        step_cfg=TrainStepConfig(microbatches=case["mb"],
                                 compress_pod_grads=case["compress"]))
    stream = TokenStream(DataConfig(vocab=cfg.vocab, global_batch=BATCH,
                                    seq_len=SEQ))
    metrics = []
    for s in range(case.get("steps", STEPS)):
        b = {"tokens": torch.from_numpy(stream.make_batch(s)["tokens"])}
        f = frames(cfg, s)
        if f is not None:
            b["frames"] = torch.from_numpy(f)
        params, opt, m = step(params, opt, b)
        metrics.append({k: float(v) for k, v in m.items()})
    residual = None
    if "ef" in opt:
        residual = {k: (v.full_tensor() if hasattr(v, "full_tensor")
                        else v).numpy()
                    for k, v in _flat(opt["ef"]["residual"]).items()}
    return {"metrics": metrics, "params": host_tree(params),
            "residual": residual}


def _flat(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], path + (k,)))
        return out
    return {"".join(f"[{k!r}]" for k in path): tree}


def train_cases(rank, world, cases, npz_paths):
    torch.set_num_threads(1)    # four ranks share the CPU
    return [train_case(rank, world, c, p) for c, p in zip(cases, npz_paths)]


def checkpoint_case(rank, world, ckpt_dir):
    """A state saved on a (2, 1, 2) mesh, restored onto (1, 2, 2) and onto
    no mesh: {"saved", "on_122", "host"} as host trees, plus each
    restored leaf's placements on the new mesh."""
    torch.set_num_threads(1)
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_smoke
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model, device_put, param_shardings
    from repro_torch.models.params import tree_leaves
    from repro_torch.optim import init_adamw

    m = build_model(dataclasses.replace(get_smoke("gemma-7b"),
                                        dtype="float32"))
    a = make_mesh((2, 1, 2), MESH_AXES)
    b = make_mesh((1, 2, 2), MESH_AXES)
    p = m.init(seed=0, device="cpu", param_dtype=torch.float32)
    p = device_put(p, param_shardings(p, a))
    opt = init_adamw(p)
    mgr = CheckpointManager(ckpt_dir, async_save=False)
    mgr.save(3, {"params": p, "opt": opt, "step": 3})
    on_b = mgr.restore(3, mesh=b)
    host = mgr.restore(3)
    placements = {str(path): (str(leaf.value.device_mesh.shape),
                              [repr(x) for x in leaf.value.placements])
                  for path, leaf in tree_leaves(on_b["params"])}
    want = {str(path): [repr(x) for x in leaf.value.placements]
            for path, leaf in tree_leaves(
                device_put(host["params"],
                           param_shardings(host["params"], b)))}
    return {"saved": host_tree(p), "on_122": host_tree(on_b["params"]),
            "host": host_tree(host["params"]),
            "moments_on_122": host_tree(on_b["opt"]["m"]),
            "step": on_b["step"], "placements": placements, "want": want,
            "files": rank == 0}


def compression_case(rank, world, grads_np, steps):
    """`ef_compress_grads` on a (2, 1, 2) mesh over ``steps`` calls, the
    residual carried: per call {"g": ..., "r": ...} as host arrays."""
    torch.set_num_threads(1)
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.distributed import ef_compress_grads
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((2, 1, 2), MESH_AXES)
    layouts = {"a": [Replicate(), Replicate(), Shard(1)],
               "b": [Replicate(), Replicate(), Replicate()],
               "c": [Replicate(), Replicate(), Shard(0)]}
    opt = {}
    out = []
    for s in range(steps):
        grads = {k: distribute_tensor(torch.from_numpy(v[s]), mesh,
                                      layouts[k], src_data_rank=None)
                 for k, v in grads_np.items()}
        g, opt = ef_compress_grads(grads, opt, mesh)
        out.append({"g": {k: v.full_tensor().numpy() for k, v in g.items()},
                    "r": {k: v.full_tensor().numpy()
                          for k, v in opt["ef"]["residual"].items()}})
    return out



# ---------------------------------------------------------------------------
# the reference side (the test process and a subprocess)
# ---------------------------------------------------------------------------

_REF = r"""
import json, os, sys, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro.configs import get_smoke
from repro.data import DataConfig, TokenStream
from repro.distributed import TrainStepConfig, make_train_step
from repro.models import Param, build_model, param_shardings
from repro.optim import AdamWConfig, init_adamw

spec = json.load(open(sys.argv[1]))
out = []
for case, path in zip(spec["cases"], spec["npz"]):
    shape, axes = case.get("mesh", ((2, 1, 2), ("pod", "data", "model")))
    mesh = jax.make_mesh(tuple(shape), tuple(axes),
                         axis_types=(AxisType.Auto,) * len(axes),
                         devices=jax.devices()[:int(np.prod(shape))])
    cfg = dataclasses.replace(get_smoke(case["arch"]), dtype=case["dtype"])
    if "dispatch" in case:
        cfg = dataclasses.replace(cfg, moe_dispatch=case["dispatch"])
    model = build_model(cfg)
    tmpl = model.abstract_params()
    with np.load(path) as npz:
        flat = {k: npz[k] for k in npz.files}
    leaves, tdef = jax.tree_util.tree_flatten_with_path(tmpl)
    params = jax.tree_util.tree_unflatten(
        tdef, [jnp.asarray(flat[jax.tree_util.keystr(p)]) for p, _ in leaves])
    params = jax.device_put(params, param_shardings(params, mesh))
    opt = init_adamw(params)
    step = jax.jit(make_train_step(
        model, AdamWConfig(**spec["opt"]), mesh=mesh,
        step_cfg=TrainStepConfig(microbatches=case["mb"],
                                 compress_pod_grads=case["compress"])))
    stream = TokenStream(DataConfig(vocab=cfg.vocab,
                                    global_batch=spec["batch"],
                                    seq_len=spec["seq"]))
    metrics = []
    for s in range(case.get("steps", spec["steps"])):
        b = {"tokens": jnp.asarray(stream.make_batch(s)["tokens"])}
        if cfg.frontend == "frames":
            b["frames"] = jnp.asarray(np.random.default_rng(1000 + s)
                                      .standard_normal((spec["batch"],
                                                        cfg.enc_seq,
                                                        cfg.d_model))
                                      .astype(np.float32))
        params, opt, m = step(params, opt, b)
        metrics.append({k: float(v) for k, v in m.items()})
    final = {jax.tree_util.keystr(p)[:-len("[<flat index 0>]")]:
             np.asarray(v, np.float32) for p, v in
             jax.tree_util.tree_flatten_with_path(params)[0]}
    np.savez(path + ".final.npz", **final)
    out.append(metrics)
json.dump(out, open(sys.argv[2], "w"))
"""




def save_reference_init(arch, path):
    """The reference's initial f32 parameters of ``arch``'s smoke config
    (``PRNGKey(0)``), by key string."""
    import jax
    from repro.configs import get_smoke
    from repro.models import build_model
    params = build_model(get_smoke(arch)).init(jax.random.PRNGKey(0))
    flat = {jax.tree_util.keystr(p): np.asarray(v, np.float32) for p, v in
            jax.tree_util.tree_flatten_with_path(params)[0]}
    np.savez(path, **flat)


def run_train_cases(d, cases, timeout=WORLD_TIMEOUT):
    """[((reference metrics, reference final params), port result)] per
    case; the reference's subprocess (every case) and the port's worlds
    (one for each mesh size, its cases in turn) run side by side in
    directory ``d``."""
    npz = []
    for i, c in enumerate(cases):
        npz.append(os.path.join(d, f"init_{i}.npz"))
        save_reference_init(c["arch"], npz[-1])
    spec = os.path.join(d, "spec.json")
    with open(spec, "w") as f:
        json.dump({"cases": cases, "npz": npz, "opt": OPT, "batch": BATCH,
                   "seq": SEQ, "steps": STEPS}, f)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    out_json = os.path.join(d, "ref.json")
    ref = subprocess.Popen([sys.executable, "-c", _REF, spec, out_json],
                           env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    try:
        from repro_torch.launch.mesh import spawn_world
        port = [None] * len(cases)
        sizes = [int(np.prod(case_mesh(c)[0])) for c in cases]
        for n in sorted(set(sizes)):
            idx = [i for i, k in enumerate(sizes) if k == n]
            got = spawn_world(train_cases, n, [cases[i] for i in idx],
                              [npz[i] for i in idx], timeout=timeout)[0]
            for i, r in zip(idx, got):
                port[i] = r
        _, err = ref.communicate(timeout=timeout)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, err[-3000:]
    with open(out_json) as f:
        ref_metrics = json.load(f)
    out = []
    for i, p in enumerate(npz):
        with np.load(p + ".final.npz") as f:
            ref_final = {k: f[k] for k in f.files}
        out.append(((ref_metrics[i], ref_final), port[i]))
    return out


def assert_case_matches(case, ref_metrics, ref_final, port):
    """Loss (and in float32 grad norm) within 1e-5 relative and every
    parameter within 1e-4; in bf16 compute the loss within 5e-4."""
    f32 = case["dtype"] == "float32"
    for got, want in zip(port["metrics"], ref_metrics):
        np.testing.assert_allclose(got["loss"], want["loss"],
                                   rtol=1e-5 if f32 else 5e-4)
        if f32:
            np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                                       rtol=1e-5)
    if f32:
        assert sorted(port["params"]) == sorted(ref_final)
        for k, v in ref_final.items():
            np.testing.assert_allclose(port["params"][k], v, rtol=0,
                                       atol=1e-4, err_msg=k)


def case_id(c):
    return (f"{c['arch']}-{c['dtype']}-mb{c['mb']}"
            + ("-compressed" if c["compress"] else "")
            + (f"-{c['dispatch']}" if "dispatch" in c else "")
            + ("-" + "x".join(map(str, c["mesh"][0])) if "mesh" in c
               else ""))


def serve_case(rank, world, arch, tuned, vocab=None, mesh_shape=(2, 1, 2)):
    """Prefill (4 x 16) and two greedy decode steps of ``arch``'s smoke
    config in float32 (its vocab replaced by ``vocab`` where given; an
    encoder-decoder's frames seeded), on a ``mesh_shape`` mesh of
    (pod, data, model) and without one, tuned layers on or off:
    (meshed logits, unmeshed logits, meshed tokens, unmeshed tokens),
    rank 0's."""
    from repro_torch.configs import get_smoke
    from repro_torch.distributed import make_serve_fns
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model, device_put, param_shardings
    from repro_torch.models.layers import use_tuned_layers
    torch.set_num_threads(1)
    mesh = make_mesh(mesh_shape, MESH_AXES)
    cfg = dataclasses.replace(get_smoke(arch), dtype="float32")
    if vocab:
        cfg = dataclasses.replace(cfg, vocab=vocab)
    model = build_model(cfg)
    params = model.init(seed=0, device="cpu", param_dtype=torch.float32)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, (4, 16)).astype(np.int32))}
    if cfg.frontend == "frames":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (4, cfg.enc_seq, cfg.d_model)).astype(np.float32))
    out = []
    for m, p in ((mesh, device_put(params, param_shardings(params, mesh))),
                 (None, params)):
        prefill, decode = make_serve_fns(model, mesh=m)
        with torch.no_grad(), use_tuned_layers(tuned):
            logits, cache = prefill(p, dict(batch))
            full = lambda t: t.full_tensor() if hasattr(t, "full_tensor") \
                else t
            got = [full(logits).numpy()]
            tok = full(logits)[:, -1:].argmax(-1).to(torch.int32)
            tokens = [tok.numpy()]
            for _ in range(2):
                lg, cache = decode(p, cache, tok)
                got.append(full(lg).numpy())
                tok = full(lg)[:, -1:].argmax(-1).to(torch.int32)
                tokens.append(tok.numpy())
        out.append((got, tokens))
    return out


def meshed_and_plain(rank, world, mesh_shape, archs):
    """For each arch's smoke config in float32 (``<arch>+grouped``: its
    MoE dispatch per sequence): two train steps on a (data, model) =
    ``mesh_shape`` mesh and two on plain tensors, from the port's own
    seed-0 parameters and one batch of 8 x 32 tokens: {arch: {"mesh":
    [(loss, grad_norm)], "plain": [...], "params": largest |meshed -
    plain| parameter after the steps}}."""
    import dataclasses
    from repro_torch.configs import get_smoke
    from repro_torch.distributed import TrainStepConfig, make_train_step
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.models.params import device_put, param_shardings
    from repro_torch.optim import AdamWConfig, init_adamw

    torch.set_num_threads(1)
    mesh = make_mesh(mesh_shape, ("data", "model"))
    out = {}
    for arch in archs:
        name, _, grouped = arch.partition("+")
        cfg = dataclasses.replace(get_smoke(name), dtype="float32")
        if grouped:
            cfg = dataclasses.replace(cfg, moe_dispatch="grouped")
        model = build_model(cfg)
        g = torch.Generator().manual_seed(0)
        batch = {"tokens": torch.randint(0, cfg.vocab, (8, 32), generator=g)}
        if cfg.frontend == "frames":
            batch["frames"] = torch.randn((8, cfg.enc_seq, cfg.d_model),
                                          generator=g)
        runs, final = {}, {}
        for tag, m in (("mesh", mesh), ("plain", None)):
            params = model.init(seed=0, device="cpu",
                                param_dtype=torch.float32)
            if m is not None:
                params = device_put(params, param_shardings(params, m))
            opt = init_adamw(params)
            step = make_train_step(model, AdamWConfig(**OPT), mesh=m,
                                   step_cfg=TrainStepConfig())
            runs[tag] = []
            for _ in range(2):
                params, opt, met = step(params, opt, dict(batch))
                runs[tag].append((float(met["loss"]),
                                  float(met["grad_norm"])))
            final[tag] = host_tree(params)
        runs["params"] = max(float(np.abs(final["mesh"][k] - v).max())
                             for k, v in final["plain"].items())
        out[arch] = runs
    return out


def optimizer_routes(rank, world, mesh_shape, arch="gemma-7b"):
    """``arch``'s smoke config in float32, two train steps on a (data,
    model) = ``mesh_shape`` mesh by each of the optimizer's routes from
    the same seed-0 parameters and batch: the plain route (eager ops on
    local shards), then the kernel route (`optim.adamw.on_card` made true) with its two
    custom ops stood in for by the plain arithmetic on the operands they
    are handed, each checked to be a whole, contiguous local shard.
    {route: {"steps": [(loss, grad_norm)], "params": host tree}, "calls":
    stand-in calls by op, "leaves": leaves, "placements": the leaves'
    distinct placements}."""
    from repro_torch.configs import get_smoke
    from repro_torch.distributed import TrainStepConfig, make_train_step
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.models.params import (device_put, param_shardings,
                                           tree_leaves)
    from repro_torch.optim import AdamWConfig, adamw, init_adamw

    torch.set_num_threads(1)
    mesh = make_mesh(mesh_shape, ("data", "model"))
    cfg = dataclasses.replace(get_smoke(arch), dtype="float32")
    model = build_model(cfg)
    g = torch.Generator().manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab, (8, 32), generator=g)}
    calls = {"sumsq": 0, "adamw": 0}

    def local(*ts):
        for t in ts:
            assert type(t) is torch.Tensor and t.is_contiguous()
        calls["sumsq" if len(ts) == 1 else "adamw"] += 1

    def sumsq(x):
        local(x)
        return torch.sum(torch.square(x.float()))

    def adamw_leaf(p, grad, m, v, scal, b1, b2, eps, weight_decay):
        local(p, grad, m, v)
        assert p.shape == grad.shape == m.shape == v.shape
        clip, lr, bc1, bc2 = scal.unbind()
        adamw.leaf_update_plain(p, grad, m, v, clip, lr, bc1, bc2,
                                AdamWConfig(b1=b1, b2=b2, eps=eps,
                                            weight_decay=weight_decay))

    out = {}
    for route in ("plain", "kernels"):
        params = model.init(seed=0, device="cpu", param_dtype=torch.float32)
        params = device_put(params, param_shardings(params, mesh))
        opt = init_adamw(params)
        step = make_train_step(model, AdamWConfig(**OPT), mesh=mesh,
                               step_cfg=TrainStepConfig())
        saved = adamw.on_card, adamw.sumsq, adamw.adamw_leaf
        if route == "kernels":
            adamw.on_card = lambda tree: True
            adamw.sumsq, adamw.adamw_leaf = sumsq, adamw_leaf
        try:
            steps = []
            for _ in range(2):
                params, opt, met = step(params, opt, dict(batch))
                steps.append((float(met["loss"]), float(met["grad_norm"])))
        finally:
            adamw.on_card, adamw.sumsq, adamw.adamw_leaf = saved
        out[route] = {"steps": steps, "params": host_tree(params)}
    out["calls"] = calls
    out["leaves"] = len(list(tree_leaves(params)))
    out["placements"] = sorted({str(tuple(leaf.value.placements))
                                for _, leaf in tree_leaves(params)})
    return out


def loss_case(rank, world, logits_np, tokens_np, placements, chunk_bytes):
    """`next_token_nll` on a (1, world) mesh of (data, model), the logits
    laid out by ``placements`` ("vocab": sharded over model, else
    whole), with ``chunk_bytes`` as the loss's chunk: (loss, the logits'
    whole gradient, the collectives a rank ran)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer

    torch.set_num_threads(1)
    transformer.NLL_CHUNK_BYTES = chunk_bytes
    mesh = make_mesh((1, world), ("data", "model"))
    pl = ((Replicate(), Shard(2)) if placements == "vocab"
          else (Replicate(), Replicate()))
    logits = distribute_tensor(torch.from_numpy(logits_np), mesh, pl,
                               src_data_rank=None).requires_grad_(True)
    tokens = distribute_tensor(torch.from_numpy(tokens_np), mesh,
                               (Replicate(), Replicate()), src_data_rank=None)
    with CommDebugMode() as comm:
        loss = transformer.next_token_nll(logits, tokens)
        loss.backward()
    return (float(loss.full_tensor()), logits.grad.full_tensor().numpy(),
            {str(k): int(v) for k, v in comm.get_comm_counts().items()})


MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes",
               "generated_code_bytes"}


def check_cell(port, ref):
    """A cell of `tools/mesh_work.py` (port and reference records) held
    to the reference: per-device flops within [0.8, 1.25], the memory
    record's keys and peak (at most 1.25 x the reference's, its
    storages named), the collective bytes within [0.5, 2.0] — without
    the ops `mesh_work.BY_DESIGN` names, which must be there."""
    import mesh_work
    assert port["status"] == "ok" and ref["status"] == "ok", ref
    row = mesh_work.row(port, ref)
    print(f"{port['arch']} {port['shape']}: flops {row['ratio']:.4f}, "
          f"peak {row['port_peak'] / row['ref_peak']:.3f}, collective "
          f"bytes {row['coll_ratio']:.3f} ({row['coll_ratio_kept']:.3f} "
          f"without the ops by design)")
    assert 0.8 <= row["ratio"] <= 1.25, row
    mem = port["memory_analysis"]
    assert set(mem) == MEMORY_KEYS and set(ref["memory_analysis"]) \
        == MEMORY_KEYS
    assert mem["argument_bytes"] == port["arg_bytes_per_device"]
    assert mem["temp_bytes"] > 0 and mem["output_bytes"] > 0
    assert mem["generated_code_bytes"] is None \
        and port["why"]["generated_code_bytes"]
    assert row["port_peak"] <= 1.25 * row["ref_peak"], row
    held = port["peak_storages"]
    assert held and all(set(h) == {"op", "shape", "dtype", "bytes"}
                        for h in held)
    assert sum(h["bytes"] for h in held) <= mem["temp_bytes"]
    ratio = row["coll_ratio"]
    if row["by_design"]:
        assert row["ref_coll_kept"] < 0.9 * row["ref_coll"], row
        ratio = row["coll_ratio_kept"]
    assert 0.5 <= ratio <= 2.0, row


def held_step_case(rank, world, arch, ckpt_dir, steps=2):
    """A meshed step from an unmeshed checkpoint: rank 0 trains
    ``arch``'s smoke config (float32) unmeshed for ``steps`` steps and
    writes its state after step ``steps - 1`` with the port's
    `CheckpointManager`; every rank restores it on a (data, model) mesh
    of the world (``restore(step, mesh=)``) and takes the last step from
    it.  Returns (rank 0) the unmeshed and the meshed step's loss and
    grad norm, the largest |meshed - unmeshed| parameter after it, and
    whether the restored parameters were the checkpoint's bit for bit."""
    import torch.distributed as dist
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_smoke
    from repro_torch.distributed import make_train_step
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, init_adamw

    torch.set_num_threads(1)
    cfg = dataclasses.replace(get_smoke(arch), dtype="float32")
    model = build_model(cfg)
    g = torch.Generator().manual_seed(0)
    batches = [{"tokens": torch.randint(0, cfg.vocab, (8, 32), generator=g)}
               for _ in range(steps)]
    mgr = CheckpointManager(ckpt_dir, keep=2, async_save=False)
    out = {}
    if rank == 0:
        params = model.init(seed=0, device="cpu", param_dtype=torch.float32)
        opt = init_adamw(params)
        step = make_train_step(model, AdamWConfig(**OPT))
        for s, b in enumerate(batches):
            if s == steps - 1:
                mgr.save(s, {"params": params, "opt": opt, "step": s})
                # copies: the update runs in place
                saved = {k: v.copy() for k, v in host_tree(params).items()}
            params, opt, m = step(params, opt, dict(b))
        out["plain"] = (float(m["loss"]), float(m["grad_norm"]))
        plain = host_tree(params)
    dist.barrier()
    mesh = make_mesh((2, world // 2), ("data", "model"))
    st = mgr.restore(steps - 1, mesh=mesh)
    restored = host_tree(st["params"])
    step = make_train_step(model, AdamWConfig(**OPT), mesh=mesh)
    params, opt, m = step(st["params"], st["opt"], dict(batches[-1]))
    meshed = host_tree(params)
    if rank == 0:
        out["mesh"] = (float(m["loss"]), float(m["grad_norm"]))
        out["params"] = max(float(np.abs(meshed[k] - v).max())
                            for k, v in plain.items())
        out["restored_exact"] = all(np.array_equal(restored[k], v)
                                    for k, v in saved.items())
        out["step"] = st["step"]
    return out


def dtensor_dispatches(rank, world, archs):
    """Ops with a DTensor operand (each one DTensor's dispatcher runs:
    sharding propagation, then the local op) in one meshed float32
    training step of each arch's smoke config on a (data, model) = (2,
    2) mesh, the step after one warm-up step, counted by a dispatch mode
    that sees every op before DTensor does: {arch: (in the step's body —
    from the step's start until the optimizer's update is entered: the
    batch's layout, the loss, its backward and the gradients' reduction
    —, in the whole step)}.  It counts any tree of the port whose
    `make_train_step` calls `optim.adamw.adamw_update` (a parent's
    too)."""
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves as leaves
    from repro_torch.configs import get_smoke
    from repro_torch.distributed import make_train_step
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.models.params import device_put, param_shardings
    from repro_torch.optim import AdamWConfig, adamw, init_adamw

    torch.set_num_threads(1)
    mesh = make_mesh((2, 2), ("data", "model"))
    counts = {"all": 0, "body": 0}
    in_body = [False]

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(isinstance(t, DTensor) for t in leaves((args, kwargs))):
                counts["all"] += 1
                counts["body"] += in_body[0]
            return func(*args, **(kwargs or {}))

    update = adamw.adamw_update

    def body_ends(*a, **k):
        in_body[0] = False
        return update(*a, **k)

    out = {}
    adamw.adamw_update = body_ends
    try:
        for arch in archs:
            cfg = dataclasses.replace(get_smoke(arch), dtype="float32")
            model = build_model(cfg)
            g = torch.Generator().manual_seed(0)
            batch = {"tokens": torch.randint(0, cfg.vocab, (8, 32),
                                             generator=g)}
            params = model.init(seed=0, device="cpu",
                                param_dtype=torch.float32)
            params = device_put(params, param_shardings(params, mesh))
            opt = init_adamw(params)
            step = make_train_step(model, AdamWConfig(**OPT), mesh=mesh)
            params, opt, _ = step(params, opt, dict(batch))
            counts.update(all=0, body=0)
            with Count():
                in_body[0] = True
                params, opt, m = step(params, opt, dict(batch))
                float(m["loss"])
            out[arch] = (counts["body"], counts["all"])
    finally:
        adamw.adamw_update = update
    return out
