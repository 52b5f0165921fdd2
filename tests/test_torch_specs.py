"""The port's sharded stand-ins against the reference's (`launch/specs.py`).

For all ten archs x every `LM_SHAPES` entry x the production meshes
pod256 (16, 16) and pod512 (2, 16, 16): `param_shardings` and the
`cell_inputs` specs of every leaf, and `tree_bytes_per_device`, equal
the reference's exactly.  The reference runs in a subprocess on 512
host devices (building the meshes; nothing is compiled or run); the
port resolves on a stand-in with the production axis names and sizes,
which is all `logical_spec` and the byte count read of a mesh.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import specs
from repro_torch.models import LM_SHAPES, build_model, param_shardings
from repro_torch.models.params import Param, tree_leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"pod256": (16, 16), "pod512": (2, 16, 16)}

_REF = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import jax
from repro.configs import ARCHS, get_config
from repro.launch.mesh import make_production_mesh
from repro.launch.specs import cell_inputs, tree_bytes_per_device
from repro.models import LM_SHAPES, build_model, param_shardings

def spec(s):
    return [list(e) if isinstance(e, tuple) else e for e in s.spec]

def leaves(tree):
    out = []
    for path, l in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out.append([jax.tree_util.keystr(path), list(l.shape),
                    str(l.dtype), spec(l.sharding)])
    return out

out = {}
for tag, multi in (("pod256", False), ("pod512", True)):
    mesh = make_production_mesh(multi_pod=multi)
    for arch in ARCHS:
        model = build_model(get_config(arch))
        ps = param_shardings(model.abstract_params(), mesh)
        out[f"{arch}|{tag}|params"] = [
            [jax.tree_util.keystr(p), spec(s)] for p, s in
            jax.tree_util.tree_flatten_with_path(ps)[0]]
        for name, shape in LM_SHAPES.items():
            args = cell_inputs(model, shape, mesh)
            out[f"{arch}|{name}|{tag}"] = {
                "leaves": leaves(args),
                "bytes": tree_bytes_per_device(args, mesh)}
json.dump(out, sys.stdout)
"""


class MeshStandIn:
    def __init__(self, shape):
        self.axis_names = (("pod", "data", "model") if len(shape) == 3
                           else ("data", "model"))
        self.devices = np.empty(shape)


@pytest.fixture(scope="module")
def ref():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _REF], capture_output=True,
                         text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout)


def _spec(s):
    return [list(e) if isinstance(e, tuple) else e for e in s.spec]


def _keystr(path, leaf):
    """The reference's keystr of a flattened leaf: a Param's value is
    its one child."""
    k = "".join(f"[{p!r}]" for p in path)
    return k + "[<flat index 0>]" if isinstance(leaf, Param) else k


def _cell_leaves(args):
    """(keystr, shape, dtype, spec) per leaf, in the reference's flatten
    order: a tuple by index, dicts by sorted key."""
    out = []
    for i, tree in enumerate(args):
        for path, leaf in (tree_leaves(tree) if isinstance(tree, dict)
                           else [((), tree)]):
            s = leaf.value if isinstance(leaf, Param) else leaf
            key = f"[{i}]" + _keystr(path, leaf)
            dtype = str(s.dtype).replace("torch.", "")
            out.append([key, list(s.shape), dtype, _spec(s.sharding)])
    return out


@pytest.mark.parametrize("tag", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_shardings_match_the_reference(ref, arch, tag):
    mesh = MeshStandIn(MESHES[tag])
    ps = param_shardings(build_model(get_config(arch)).abstract_params(),
                         mesh)
    got = [[_keystr(p, s), _spec(s)]
           for p, s in tree_leaves(ps)]
    assert got == ref[f"{arch}|{tag}|params"]


@pytest.mark.parametrize("tag", list(MESHES))
@pytest.mark.parametrize("shape", list(LM_SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cell_inputs_and_bytes_per_device_match_the_reference(ref, arch,
                                                              shape, tag):
    mesh = MeshStandIn(MESHES[tag])
    args = specs.cell_inputs(build_model(get_config(arch)), LM_SHAPES[shape],
                             mesh)
    want = ref[f"{arch}|{shape}|{tag}"]
    assert _cell_leaves(args) == want["leaves"]
    assert specs.tree_bytes_per_device(args, mesh) == want["bytes"]
