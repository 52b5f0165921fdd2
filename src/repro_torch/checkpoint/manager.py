"""Checkpoint manager: async save, atomic commit, retention.

Layout (one directory per step), the reference's::

    <dir>/step_00000042/
        arrays.npz        the leaves, keyed by the reference's tree paths
        manifest.json     each leaf's name, key path, kind, dims, dtype
        meta.json         {"step": 42, "time": ..., "complete": true}

``arrays.npz`` keys are the strings the reference's
``jax.tree_util.keystr`` gives the same tree — ``['params']['blocks']
['attn']['wk'][<flat index 0>]`` for a Param's value, ``['opt']
['count']``, ``['step']`` — so both packages' files name the same
leaves the same way.  Where the reference pickles a JAX treedef
(readable only by JAX), the port writes ``manifest.json``.  bfloat16
leaves, which numpy lacks, are stored as their raw 16-bit words.

Atomicity: a save writes ``step_XXXXXXXX.tmp`` and ``os.rename``\\ s it
to commit, so an interrupted save never shadows the previous good
checkpoint.  Async: one background worker thread behind a size-1
queue; ``wait()`` joins outstanding saves, and a new save blocks until
the previous one is written (bounded memory).  Every leaf is copied to
the host in `save`'s caller before it returns, so the next step's
in-place update cannot reach a snapshot being written.

On a mesh a save gathers every DTensor leaf whole to the host on every
rank (a collective, so every rank calls `save`); only rank 0 writes.
Restore returns host (CPU) tensors unless given a ``device``, or, with
a ``mesh``, places every Param leaf (parameters and Adam moments) on it
by `named_sharding` of its dims under ``rules`` — whatever mesh the
checkpoint was saved from, which is the elastic part.
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.distributed.sharding import (Rules, WEIGHT_RULES,
                                              named_sharding)
from repro_torch.models.params import Param, distribute, tree_leaves

__all__ = ["CheckpointManager"]

_PARAM_KEY = "[<flat index 0>]"     # keystr of a Param's one child


def _keystr(path: Tuple[str, ...]) -> str:
    return "".join(f"[{k!r}]" for k in path)


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _writer() -> bool:
    """Rank 0 of a process group, or the only process."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def _to_host(x) -> Tuple[str, np.ndarray, str]:
    """(kind, host array, dtype name) of one leaf, a tensor or an int;
    a tensor is copied even when it already lives on the CPU."""
    if isinstance(x, torch.Tensor):
        if _is_dtensor(x):
            x = x.full_tensor()
        t = x.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return "tensor", t.view(torch.int16).numpy().view(np.uint16), \
                "bfloat16"
        return "tensor", t.numpy(), str(t.dtype).replace("torch.", "")
    if isinstance(x, bool) or not isinstance(x, int):
        raise TypeError(f"cannot checkpoint a leaf of type {type(x)}")
    arr = np.asarray(x)
    return "int", arr, str(arr.dtype)


def _flatten_with_names(tree) -> Tuple[List[str], List[np.ndarray],
                                       List[Dict]]:
    """The tree's leaves on the host, their reference key strings and
    the manifest entries that rebuild the tree."""
    names, arrays, manifest = [], [], []
    for path, leaf in tree_leaves(tree):
        entry: Dict[str, Any] = {"path": list(path)}
        name = _keystr(path)
        if isinstance(leaf, Param):
            name += _PARAM_KEY
            entry["dims"] = list(leaf.dims)
            leaf = leaf.value
        kind, arr, dtype = _to_host(leaf)
        entry.update(name=name, kind="param" if "dims" in entry else kind,
                     dtype=dtype, shape=list(arr.shape))
        names.append(name)
        arrays.append(arr)
        manifest.append(entry)
    return names, arrays, manifest


def _from_host(entry: Dict, arr: np.ndarray, device):
    if entry["kind"] == "int":
        return int(arr)
    if entry["dtype"] == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    t = t.to(device)
    return Param(t, tuple(entry["dims"])) if entry["kind"] == "param" else t


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 async_save: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        os.makedirs(directory, exist_ok=True)
        self._q: "queue.Queue" = queue.Queue(maxsize=1)
        self._worker: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        if async_save:
            self._worker = threading.Thread(target=self._run, daemon=True)
            self._worker.start()

    # -- paths ---------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}")

    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                meta = os.path.join(self.directory, name, "meta.json")
                if os.path.exists(meta):
                    out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # -- save ----------------------------------------------------------------
    def save(self, step: int, tree: Dict[str, Any],
             extra_meta: Optional[Dict] = None) -> None:
        """tree: e.g. {"params": ..., "opt": ..., "step": int}.  Returns
        once every leaf has been copied to the host."""
        names, arrays, manifest = _flatten_with_names(tree)
        if not _writer():
            return
        payload = (step, names, arrays, manifest, extra_meta or {})
        if self.async_save:
            if self._error:
                raise RuntimeError("previous async save failed") \
                    from self._error
            self._q.put(payload)      # blocks if a save is in flight
        else:
            self._write(*payload)

    def _run(self):
        while True:
            payload = self._q.get()
            if payload is None:
                self._q.task_done()
                return
            try:
                self._write(*payload)
            except BaseException as e:   # surfaced on the next save/wait
                self._error = e
            finally:
                self._q.task_done()

    def _write(self, step, names, arrays, manifest, extra_meta):
        final = self._step_dir(step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{n: a for n, a in zip(names, arrays)})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({"leaves": manifest}, f)
        meta = {"step": int(step), "time": time.time(),
                "complete": True, **extra_meta}
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)          # atomic commit
        self._gc()

    def wait(self):
        if self.async_save:
            self._q.join()
            if self._error:
                raise RuntimeError("async save failed") from self._error

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # -- restore ---------------------------------------------------------------
    def restore(self, step: Optional[int] = None, mesh=None,
                rules: Rules = WEIGHT_RULES, device=None) -> Dict[str, Any]:
        """Load a checkpoint: tensors on the host, or on ``device``, or
        with ``mesh`` each Param leaf placed on the mesh by its dims
        (other tensors on the mesh's device, whole)."""
        import torch.distributed as dist
        if dist.is_initialized():
            # every rank reads what rank 0 has written
            self.wait()
            dist.barrier()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        if mesh is not None and device is None:
            # this rank's card: an index, which may be 0
            device = (torch.device("cuda", torch.cuda.current_device())
                      if mesh.device_type == "cuda" else mesh.device_type)
        d = self._step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)["leaves"]
        tree: Dict[str, Any] = {}
        with np.load(os.path.join(d, "arrays.npz")) as npz:
            for entry in manifest:
                node = tree
                for k in entry["path"][:-1]:
                    node = node.setdefault(k, {})
                leaf = _from_host(entry, npz[entry["name"]],
                                  "cpu" if device is None else device)
                if mesh is not None and isinstance(leaf, Param):
                    leaf = Param(distribute(leaf.value, named_sharding(
                        leaf.dims, tuple(leaf.shape), rules, mesh)),
                        leaf.dims)
                node[entry["path"][-1]] = leaf
        return tree

    def meta(self, step: int) -> Dict:
        with open(os.path.join(self._step_dir(step), "meta.json")) as f:
            return json.load(f)

    def close(self):
        if self.async_save and self._worker is not None:
            self._q.put(None)
            self._worker.join(timeout=5)
