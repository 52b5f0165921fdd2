"""Multi-pod dry-run: price a (arch x shape x mesh) cell with no device.

For every cell, on the single-pod 16x16 mesh and the 2x16x16 multi-pod
mesh, the production mesh stands on a fake process group of 256 or 512
ranks (``torch.distributed``'s ``"fake"`` backend, this process rank 0)
and every input is a ``meta`` DTensor laid out by the rule tables
(`launch.specs`).  The cell's step — the meshed train step, prefill or
one decode step — then runs once under `core.mix.trace_fn`: DTensor
turns each op into rank 0's local ops and collectives on its shards, so
the trace is the per-device program, and nothing is allocated.

One JSON record per cell goes under ``experiments/dryrun/``, with the
reference's keys.  The analytic fields (``chips``, ``microbatches``,
``arg_bytes_per_device``, ``model_flops``, ``n_params``,
``n_active_params``, ``status``/``reason``) are the reference's
arithmetic; ``flops``, ``bytes_accessed``, ``vpu_flops`` and
``transcendentals`` come from `core.mix.mix_from_graph` of the trace;
``collective_bytes``, ``collectives_by_kind`` and ``collective_counts``
from the trace's collectives (each one's output bytes, the reference's
HLO accounting; the counts also from ``CommDebugMode``);
``memory_analysis`` holds the reference's keys from the trace's storages
(`lower_step`): ``argument_bytes`` (the arguments' local bytes, equal to
``arg_bytes_per_device``), ``output_bytes``, ``temp_bytes`` (the peak of
the storages the step makes while it runs) and ``generated_code_bytes``
(null); ``peak_storages`` names the largest storages alive at that peak
(the aten op that made each, shape, dtype, bytes).  A shard moved from
one tensor dim to another is traced as the card moves it, one
all-to-all (`_card_all_to_all`).  The fields an XLA compile gives and a trace does not
(``hlo_instructions``, ``xla_cost_analysis``, ``compile_s``,
``generated_code_bytes``) are null, each with its reason under
``"why"``.  ``roofline`` holds the three
terms under the H100 (`core.roofline`), analysis only.  A cell the fake
group cannot carry records ``status: "error"``.

Usage:
    python -m repro_torch.launch.dryrun --arch gemma-7b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--multi-pod-only|--single-pod-only]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback
from typing import Dict, Optional

__all__ = ["dryrun_cell", "lower_step", "lower_train_step", "save_record",
           "main"]

_WHY = {
    "generated_code_bytes": "no compiled executable: the step runs as "
                            "eager torch ops (its kernels' code is "
                            "torch's own)",
    "hlo_instructions": "no HLO module: the step is a torch trace",
    "xla_cost_analysis": "no XLA compile: flops and bytes come from the "
                         "trace's mix",
    "compile_s": "nothing is compiled; lower_s is the trace's time",
}


def _fake_world(size: int) -> None:
    """A fake process group of ``size`` ranks, this process rank 0.  A
    new world first clears DTensor's caches of sharding plans: they are
    keyed by meshes, and a mesh compares equal to a destroyed world's of
    the same shape and names, so a cached plan would hand the new
    world's trace the old world's process groups."""
    import torch.distributed as dist
    from torch.distributed.tensor import _redistribute, debug
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == size:
            return
        dist.destroy_process_group()
    for clear in (getattr(debug, "_clear_python_sharding_prop_cache", None),
                  getattr(debug, "_clear_fast_path_sharding_prop_cache",
                          None),
                  getattr(getattr(_redistribute, "_gen_transform_infos",
                                  None), "cache_clear", None)):
        if clear is not None:
            clear()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)


def _build_step_fn(model, shape, mesh, microbatches: int = 0,
                   step_cfg_overrides: Optional[Dict] = None):
    from repro_torch.distributed import (TrainStepConfig, make_serve_fns,
                                         make_train_step)
    from repro_torch.distributed.train import recommended_microbatches
    from repro_torch.optim import AdamWConfig

    overrides = dict(step_cfg_overrides or {})
    if shape.kind == "train":
        mb = microbatches or recommended_microbatches(model.cfg, shape,
                                                      mesh)
        step_cfg = TrainStepConfig(microbatches=mb, **overrides)
        return make_train_step(model, AdamWConfig(), mesh=mesh,
                               step_cfg=step_cfg), mb
    step_cfg = TrainStepConfig(**overrides)
    prefill, decode = make_serve_fns(model, mesh=mesh, step_cfg=step_cfg)
    if shape.kind == "prefill":
        return prefill, 1
    return decode, 1


def _parse_variant(variant: str, cfg):
    """Variant string -> (cfg, act rules, cache rules, microbatch
    override).  Components joined by '+': ``sp`` (sequence-parallel
    residuals), ``kvseq`` (split-KV decode cache), ``mb<k>`` (microbatch
    override), ``padE<n>`` (pad MoE experts to n), ``moegrp``,
    ``kvrep<n>``, ``rdots``."""
    import dataclasses as _dc
    from repro_torch.distributed.sharding import (ACT_RULES, ACT_RULES_SP,
                                                  CACHE_RULES,
                                                  CACHE_RULES_SEQSHARD)
    act_rules, cache_rules, mb = ACT_RULES, CACHE_RULES, 0
    for part in [p for p in (variant or "").split("+") if p]:
        if part == "baseline":
            continue
        elif part == "sp":
            act_rules = ACT_RULES_SP
        elif part == "kvseq":
            cache_rules = CACHE_RULES_SEQSHARD
        elif part.startswith("mb"):
            mb = int(part[2:])
        elif part.startswith("padE"):
            cfg = _dc.replace(cfg, pad_experts_to=int(part[4:]))
        elif part == "moegrp":
            cfg = _dc.replace(cfg, moe_dispatch="grouped")
        elif part.startswith("kvrep"):
            cfg = _dc.replace(cfg, kv_repeat=int(part[5:]))
        elif part == "rdots":
            cfg = _dc.replace(cfg, remat="dots")
        else:
            raise ValueError(f"unknown variant component {part!r}")
    return cfg, act_rules, cache_rules, mb


def _step_args(shape, dargs):
    """The step's call arguments from the cell's DTensor inputs: the
    decode cache's ``pos`` back to the host int the port's cache holds."""
    if shape.kind == "decode":
        params, cache, token = dargs
        return (params, {**cache, "pos": shape.seq_len - 1}, token)
    return dargs


def _local_tensors(tree) -> list:
    """Each distinct local storage's tensor among a tree's tensors and
    DTensors (params, dicts, tuples), once."""
    import torch
    from torch.distributed.tensor import DTensor

    from repro_torch.models.params import Param
    out, seen = [], set()

    def walk(t):
        if isinstance(t, Param):
            walk(t.value)
        elif isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, (tuple, list)):
            for v in t:
                walk(v)
        elif isinstance(t, torch.Tensor):
            loc = t._local_tensor if isinstance(t, DTensor) else t
            key = id(loc.untyped_storage())
            if key not in seen:
                seen.add(key)
                out.append(loc)
    walk(tree)
    return out


def _storage_bytes(tensors) -> int:
    return int(sum(t.untyped_storage().nbytes() for t in tensors))


@contextlib.contextmanager
def _card_all_to_all():
    """DTensor moves a shard from one tensor dim to another with one
    all-to-all on the card (NCCL), but on a CPU mesh — the fake group's
    — with an all-gather of the whole dim and a slice.  Within it a
    trace on ``meta`` tensors takes the card's route: one all-to-all of
    the shard's bytes, its result the new shard's shape (no values: a
    meta trace has none)."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import placement_types as pt
    orig = getattr(pt, "shard_dim_alltoall", None)
    if orig is None:
        yield
        return

    def on_card(x, gather_dim, shard_dim, mesh, mesh_dim):
        if x.device.type != "meta":
            return orig(x, gather_dim, shard_dim, mesh, mesh_dim)
        y = funcol.all_to_all_single(x.reshape(-1), None, None,
                                     (mesh, mesh_dim))
        if isinstance(y, funcol.AsyncCollectiveTensor):
            y = y.wait()
        shape = list(x.shape)
        shape[gather_dim] *= mesh.size(mesh_dim)
        shape[shard_dim] //= mesh.size(mesh_dim)
        return y.view(shape)
    pt.shard_dim_alltoall = on_card
    try:
        yield
    finally:
        pt.shard_dim_alltoall = orig


def lower_step(step_fn, *args, grad: bool = True, top: int = 10):
    """Trace ``step_fn(*args)`` (DTensors on a mesh, meta locals) as the
    per-device program: its `InstructionMix` and its collectives, each
    counted once with its output bytes, and its memory: the arguments'
    local bytes, the result's, and the peak of the storages the step's
    ops make while it runs (`core.mix.live_bytes`; ``temp_bytes`` = that
    peak, the reference's "peak live minus arguments"), with the
    ``top`` largest storages alive at that peak (``peak_storages``: the
    op that made each, shape, dtype, bytes).  Returns a
    `core.autotuner.LoweredStep` (`GraphTuner` scores it)."""
    import torch
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.core.autotuner import LoweredStep
    from repro_torch.core.hlo import CollectiveStats
    from repro_torch.core.mix import (_T_COLLECTIVE, _nbytes, live_bytes,
                                      mix_from_graph, trace_meta_fn)

    arg_locals = _local_tensors(args)
    result = []
    with torch.enable_grad() if grad else torch.no_grad(), \
            _card_all_to_all(), CommDebugMode() as comm, \
            live_bytes(keep=arg_locals) as live:
        graph = trace_meta_fn(lambda *a: result.append(step_fn(*a)), *args)
    memory = {"argument_bytes": _storage_bytes(arg_locals),
              "output_bytes": _storage_bytes(_local_tensors(result)),
              "temp_bytes": int(live.peak), "generated_code_bytes": None}
    del result
    by_kind: Dict[str, float] = {}
    counts: Dict[str, float] = {}
    for op in graph.ops:
        kind = _T_COLLECTIVE.get(op.name.rstrip("_"))
        if kind is not None:
            by_kind[kind] = by_kind.get(kind, 0.0) + _nbytes(op.outputs)
            counts[kind] = counts.get(kind, 0.0) + 1.0
    return LoweredStep(
        mix_from_graph(graph),
        CollectiveStats(by_kind, counts, sum(by_kind.values()), []),
        {str(k): int(v) for k, v in comm.get_comm_counts().items()},
        memory, live.at_peak(top))


def lower_train_step(cfg, batch: int, seq: int, microbatches: int = 1,
                     top: int = 10):
    """`lower_step` of ``cfg``'s train step with no mesh, at ``batch`` x
    ``seq`` tokens: the f32 master parameters, AdamW's moments and the
    batch on ``meta`` (the arguments), and the storages one step makes
    (the temporaries) — what a card holds for the same step."""
    from repro_torch.distributed import TrainStepConfig, make_train_step
    from repro_torch.models import build_model
    from repro_torch.models.config import ShapeSpec
    from repro_torch.models.model import batch_shapes
    from repro_torch.optim import AdamWConfig, init_adamw

    model = build_model(cfg)
    params = model.abstract_params()
    step = make_train_step(model, AdamWConfig(), step_cfg=TrainStepConfig(
        microbatches=microbatches))
    return lower_step(step, params, init_adamw(params), batch_shapes(
        cfg, ShapeSpec("train", seq, batch, "train")), top=top)


def dryrun_cell(arch: str, shape_name: str, multi_pod: bool,
                variant: str = "baseline", trace: bool = True,
                cfg=None) -> Dict:
    """One cell's record.  ``trace=False`` records the analytic fields
    only (the traced ones null, with why); ``cfg`` overrides the arch's
    config (a depth cut)."""
    from repro_torch.configs import get_config
    from repro_torch.core.hw import H100_SXM
    from repro_torch.core.roofline import roofline_from_artifacts
    from repro_torch.launch.mesh import (ici_links, make_production_mesh,
                                         mesh_num_chips)
    from repro_torch.launch.specs import (cell_inputs, to_dtensors,
                                          tree_bytes_per_device)
    from repro_torch.models import build_model
    from repro_torch.models.config import LM_SHAPES

    cfg = cfg or get_config(arch)
    cfg, act_rules, cache_rules, mb_override = _parse_variant(variant, cfg)
    model = build_model(cfg)
    shape = LM_SHAPES[shape_name]
    mesh_tag = "pod512" if multi_pod else "pod256"
    rec: Dict = {"arch": arch, "shape": shape_name, "mesh": mesh_tag,
                 "kind": shape.kind, "variant": variant}

    ok, why = model.supports_shape(shape)
    if not ok:
        rec.update(status="skipped", reason=why)
        return rec

    t0 = time.time()
    _fake_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    chips = mesh_num_chips(mesh)
    args = cell_inputs(model, shape, mesh, act_rules=act_rules,
                       cache_rules=cache_rules)
    step_fn, microbatches = _build_step_fn(
        model, shape, mesh, microbatches=mb_override,
        step_cfg_overrides={"act_rules": act_rules,
                            "cache_rules": cache_rules})
    rec["microbatches"] = microbatches
    rec.update(
        status="ok", chips=chips,
        arg_bytes_per_device=int(tree_bytes_per_device(args, mesh)),
        model_flops=model.model_flops(shape),
        n_params=cfg.num_params(),
        n_active_params=cfg.num_active_params(),
        ici_links=ici_links(mesh, spec=H100_SXM),
        hlo_instructions=None,
        xla_cost_analysis=None, compile_s=None, why=dict(_WHY))
    traced = ("flops", "vpu_flops", "transcendentals", "bytes_accessed",
              "unknown_trip_loops", "collective_bytes",
              "collectives_by_kind", "collective_counts", "lower_s",
              "roofline", "memory_analysis", "peak_storages")
    if not trace:
        rec.update({k: None for k in traced})
        rec["why"]["traced"] = "trace=False: analytic fields only"
        return rec

    dargs = to_dtensors(args)
    lowered = lower_step(step_fn, *_step_args(shape, dargs),
                         grad=(shape.kind == "train"))
    t_lower = time.time() - t0
    mix, coll = lowered.mix, lowered.collectives
    by_kind, counts = coll.by_kind_bytes, coll.by_kind_count
    terms = roofline_from_artifacts(
        name=f"{arch}_{shape_name}_{mesh_tag}", cost={}, hlo_text=None,
        chips=chips, model_flops=rec["model_flops"], spec=H100_SXM,
        collectives=coll, mix=mix)
    rec.update(
        lower_s=round(t_lower, 2),
        flops=mix.mxu_flops, vpu_flops=mix.vpu_flops,
        transcendentals=mix.trans_flops, bytes_accessed=mix.hbm_bytes,
        unknown_trip_loops=0,
        collective_bytes=coll.total_bytes, collectives_by_kind=by_kind,
        collective_counts=counts,
        comm_debug_counts=dict(lowered.comm_debug_counts),
        # the arguments as the cell gives them (the decode cache's
        # position a device scalar, as the reference's)
        memory_analysis=dict(lowered.memory, argument_bytes=_storage_bytes(
            _local_tensors(dargs))),
        peak_storages=lowered.peak_storages,
        roofline={"spec": H100_SXM.name, **{
            k: getattr(terms, k) for k in (
                "t_compute", "t_memory", "t_collective", "dominant",
                "useful_ratio", "roofline_frac")}})
    return rec


def save_record(rec: Dict, out_dir: str = "experiments/dryrun"):
    os.makedirs(out_dir, exist_ok=True)
    suffix = ("" if rec.get("variant", "baseline") == "baseline"
              else "_" + rec["variant"].replace("+", "_"))
    name = f"{rec['arch']}_{rec['shape']}_{rec['mesh']}{suffix}.json"
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(rec, f, indent=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--multi-pod-only", action="store_true")
    ap.add_argument("--out-dir", type=str, default="experiments/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--analytic-only", action="store_true",
                    help="record the analytic fields, trace no step")
    ap.add_argument("--variant", type=str, default="baseline",
                    help="sp|kvseq|mb<k>|padE<n> joined by '+'")
    args = ap.parse_args(argv)

    from repro_torch.configs import ARCHS
    from repro_torch.models.config import LM_SHAPES

    archs = [args.arch] if args.arch else ARCHS
    shapes = [args.shape] if args.shape else list(LM_SHAPES)
    pods = []
    if not args.multi_pod_only:
        pods.append(False)
    if args.multi_pod or args.all or args.multi_pod_only:
        if not args.single_pod_only:
            pods.append(True)

    n_fail = 0
    for arch in archs:
        for shape in shapes:
            for mp in pods:
                tag = "pod512" if mp else "pod256"
                path = os.path.join(args.out_dir,
                                    f"{arch}_{shape}_{tag}.json")
                if args.skip_existing and os.path.exists(path):
                    print(f"[dryrun] {arch} x {shape} x {tag}: cached")
                    continue
                try:
                    rec = dryrun_cell(arch, shape, mp, variant=args.variant,
                                      trace=not args.analytic_only)
                except Exception as e:
                    rec = {"arch": arch, "shape": shape, "mesh": tag,
                           "status": "error", "error": str(e),
                           "traceback": traceback.format_exc()}
                    n_fail += 1
                save_record(rec, args.out_dir)
                status = rec["status"]
                extra = ""
                if status == "ok" and rec.get("flops") is not None:
                    extra = (f"flops/dev={rec['flops']:.3e} "
                             f"coll={rec['collective_bytes']:.3e}B "
                             f"trace={rec['lower_s']}s")
                elif status == "error":
                    extra = rec["error"][:160]
                elif status != "ok":
                    extra = rec.get("reason", "")
                print(f"[dryrun] {arch} x {shape} x {tag}: "
                      f"{status} {extra}", flush=True)
    if n_fail:
        raise SystemExit(f"{n_fail} dry-run cells failed")
    print("[dryrun] all requested cells passed")


if __name__ == "__main__":
    main()
