"""The public API the port shares with the reference (ROADMAP C1, C2).

* Every name in the ``__all__`` of the reference's registry, its
  ``tuning_cache`` package, the kernel modules and every ported
  ``core.*`` and ``models.*`` module, and every public name of its
  config registry (which has no ``__all__``), is in the port's, or is
  listed in `UNPORTED` with its reason: a TPU-only name or a JAX-only
  front end with its torch counterpart named; ``*_pallas`` entry points are skipped, their counterparts
  being the port's ``*_cuda`` wrappers.
* Under ``tpu-v5e`` a problem factory registered with `register` gives
  the reference's records; the default path leaves the reference's
  memo keys (`dispatch_memo_keys`); `reset_models` drops the model memo
  and keeps the dispatch memo; `frozen_table` serves the reference's
  frozen answers and is ``None`` where the reference's is.
* The scalar ``*_static_info`` helpers give the reference's static info.
"""
import __future__
import dataclasses
import importlib
import inspect

import numpy as np
import pytest

import repro.kernels  # noqa: F401  (registers every reference kernel)
import repro_torch.kernels  # noqa: F401
from repro import tuning_cache as ref_tc
from repro.core.search import SearchSpace as RefSpace
from repro.core.target import use_target as ref_use_target
from repro.tuning_cache import registry as ref_reg
from repro_torch import tuning_cache as tc
from repro_torch.core.search import SearchSpace
from repro_torch.core.target import use_target
from repro_torch.tuning_cache import registry as reg

# reference names the port does not have, each with its reason
UNPORTED = {
    "default_interpret": "TPU-only: Pallas interpret mode off a TPU",
    "CompilerParams": "TPU-only: Pallas TPU compiler parameters",
    "tpu_compiler_params": "TPU-only: Pallas TPU compiler parameters",
    "mix_from_jaxpr": "takes a jaxpr; the torch counterpart is "
                      "repro_torch.core.mix.mix_from_graph over trace_fn",
}
MODULES = ["tuning_cache.registry", "tuning_cache", "kernels.matmul",
           "kernels.matvec", "kernels.atax", "kernels.bicg",
           "kernels.jacobi3d", "kernels.flash_attention",
           "kernels.rms_norm", "kernels.mlp_matmul", "kernels.stencil2d",
           "kernels.common", "kernels.ref", "kernels.api",
           "kernels.variants", "kernels.megamatmul", "core.annotations",
           "core.autotuner", "core.hlo", "core.isa", "core.mix",
           "core.occupancy", "core.pipeline", "core.predict",
           "core.roofline", "core.search", "core.target", "configs",
           "models.config", "models.layers", "models.model",
           "models.params", "models.transformer", "models.moe",
           "models.ssd", "models.encdec", "optim.adamw", "data.pipeline",
           "checkpoint.manager", "runtime.fault", "distributed.train",
           "distributed.sharding", "distributed.compression",
           "launch.mesh", "launch.specs"]


def _public(mod):
    """A module's ``__all__``; for a module without one (the reference's
    config registry), the public names it defines or binds to data."""
    if hasattr(mod, "__all__"):
        return list(mod.__all__)
    return [n for n, v in vars(mod).items()
            if not n.startswith("_") and not inspect.ismodule(v)
            and not isinstance(v, __future__._Feature)
            and getattr(v, "__module__", mod.__name__) == mod.__name__]


def test_every_unported_name_has_a_reason():
    assert all(isinstance(v, str) and v for v in UNPORTED.values())


@pytest.mark.parametrize("module", MODULES)
def test_every_reference_name_is_ported_or_listed(module):
    ref = importlib.import_module(f"repro.{module}")
    port = importlib.import_module(f"repro_torch.{module}")
    missing = [n for n in _public(ref) if n not in port.__all__
               and n not in UNPORTED and not n.endswith("_pallas")]
    assert missing == []
    for n in port.__all__:
        assert hasattr(port, n), n
    # a listed name is listed because it is missing, not by habit
    assert not [n for n in UNPORTED if n in port.__all__]


@pytest.mark.parametrize("package", ["distributed", "launch", "models"])
def test_every_reference_package_reexport_is_in_the_port(package):
    """The names the reference's packages bind (they have no
    ``__all__``) are bound by the port's packages too."""
    ref = importlib.import_module(f"repro.{package}")
    port = importlib.import_module(f"repro_torch.{package}")
    names = [n for n, v in vars(ref).items()
             if not n.startswith("_") and not inspect.ismodule(v)
             and not isinstance(v, __future__._Feature)]
    assert names and [n for n in names if not hasattr(port, n)] == []


@pytest.mark.parametrize("name", ["register", "unregister",
                                  "invalidate_kernel", "frozen_table"])
def test_the_package_reexports_the_registry(name):
    assert getattr(tc, name) is getattr(reg, name)
    assert getattr(ref_tc, name) is getattr(ref_reg, name)


@pytest.fixture
def fresh():
    ref_tc.set_default_db(ref_tc.TuningDatabase())
    tc.set_default_db(tc.TuningDatabase())
    yield
    ref_reg.unregister("c1_factory")
    reg.unregister("c1_factory")
    ref_tc.reset_default_db()
    tc.reset_default_db()


def _register_factories():
    """The same hand-rolled matmul problem in both packages, through
    each package's `register` decorator."""
    from repro.kernels.matmul import matmul_static_info as ref_info
    from repro_torch.kernels.matmul import matmul_static_info as info
    axes = {"bm": (64, 128, 256), "bn": (128, 256), "bk": (128, 512)}

    @ref_reg.register("c1_factory")
    def ref_factory(m: int, n: int, k: int, dtype: str = "float32"):
        return ref_reg.TuningProblem(
            space=RefSpace(dict(axes)),
            static_info=lambda p: ref_info(m, n, k, dtype, p))

    @reg.register("c1_factory")
    def factory(m: int, n: int, k: int, dtype: str = "float32"):
        return reg.TuningProblem(
            space=SearchSpace(dict(axes)),
            static_info=lambda p: info(m, n, k, dtype, p))
    return ref_factory, factory


SIGS = [dict(m=512, n=1024, k=2048), dict(m=4096, n=256, k=512,
                                          dtype="bfloat16")]


@pytest.mark.parametrize("sig", SIGS, ids=["f32", "bf16"])
def test_a_registered_factory_gives_the_reference_records(fresh, sig):
    ref_factory, factory = _register_factories()
    assert "c1_factory" in reg.registered()
    with pytest.raises(ValueError, match="already registered"):
        reg.register("c1_factory")(factory)
    ref_db, db = ref_tc.TuningDatabase(), tc.TuningDatabase()
    want = ref_tc.lookup_or_tune("c1_factory", spec="tpu-v5e", db=ref_db,
                                 **sig)
    got = tc.lookup_or_tune("c1_factory", spec="tpu-v5e", db=db, **sig)
    assert got == want
    (r,), (p,) = ref_db.snapshot(), db.snapshot()
    assert p.key.to_dict() == r.key.to_dict()
    assert p.key.digest == r.key.digest
    assert (p.params, p.space_size) == (r.params, r.space_size)
    assert p.predicted_s == pytest.approx(r.predicted_s, rel=1e-12)
    # the declared default makes every spelling one key
    full = dict(dict(dtype="float32"), **sig)
    assert reg.normalize_signature("c1_factory", sig) == full
    assert reg.normalize_signature("c1_factory", sig) == \
        ref_reg.normalize_signature("c1_factory", sig)


def test_memo_keys_reset_models_and_frozen_table_match(fresh):
    _register_factories()
    sigs = [("c1_factory", s) for s in SIGS] + [
        ("matmul", dict(m=256, n=3072, k=3072, dtype="bfloat16")),
        ("rms_norm", dict(m=256, d=3072, dtype="bfloat16"))]
    with ref_use_target("tpu-v5e"), use_target("tpu-v5e"):
        assert tc.frozen_table("c1_factory") is None
        assert ref_tc.frozen_table("c1_factory") is None
        for k, s in sigs:
            assert tc.lookup_or_tune(k, **s) == ref_tc.lookup_or_tune(k, **s)
        keys = sorted(reg.dispatch_memo_keys(), key=repr)
        assert keys == sorted(ref_reg.dispatch_memo_keys(), key=repr)
        assert len(keys) == len(sigs)
        assert {k[0] for k in keys} == {k for k, _ in sigs}
        # reset_models drops the per-spec model memo, not the dispatch
        # memo
        assert reg._DEFAULT_MODELS
        reg.reset_models()
        ref_reg.reset_models()
        assert not reg._DEFAULT_MODELS and not ref_reg._DEFAULT_MODELS
        assert sorted(reg.dispatch_memo_keys(), key=repr) == keys
        # the frozen tables: the reference's answers, None past them
        ref_tc.get_default_db().clear()
        for k, s in sigs:
            ref_tc.lookup_or_tune(k, **s)
        tc.freeze()
        ref_tc.freeze()
        for k, s in sigs:
            probe, ref_probe = tc.frozen_table(k), ref_tc.frozen_table(k)
            assert probe is not None and ref_probe is not None
            assert probe(s) == ref_probe(s) == tc.lookup_or_tune(k, **s)
        assert tc.frozen_table("c1_factory", mode="hybrid") is None
        assert tc.frozen_table("no_such_kernel") is None
        tc.thaw()
        assert tc.frozen_table("c1_factory") is None


def _info_fields(info):
    """A KernelStaticInfo as a flat dict of numbers and strings."""
    out = {}
    for part in ("mix", "occupancy"):
        for k, v in dataclasses.asdict(getattr(info, part)).items():
            out[f"{part}.{k}"] = v
    return out


STATIC_INFO = [
    ("matmul", dict(m=512, n=1024, k=2048), dict(bm=128, bn=256, bk=512)),
    ("matvec", dict(m=2048, n=4096), dict(bm=256, bk=512)),
    ("atax", dict(m=2048, n=1024), dict(bm=128)),
    ("bicg", dict(m=1024, n=2048), dict(bm=256)),
    ("jacobi3d", dict(z=64, y=128, x=128), dict(bz=8)),
    ("flash_attention", dict(b=2, h=4, sq=1024, skv=1024, d=128),
     dict(bq=128, bkv=256)),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel,shape,params", STATIC_INFO,
                         ids=[c[0] for c in STATIC_INFO])
def test_static_info_helpers_match_the_reference(kernel, shape, params,
                                                 dtype):
    mod = "flash_attention" if kernel == "flash_attention" else kernel
    name = "flash_static_info" if kernel == "flash_attention" \
        else f"{kernel}_static_info"
    ref_fn = getattr(importlib.import_module(f"repro.kernels.{mod}"), name)
    fn = getattr(importlib.import_module(f"repro_torch.kernels.{mod}"), name)
    with ref_use_target("tpu-v5e"), use_target("tpu-v5e"):
        want = _info_fields(ref_fn(dtype=dtype, params=params, **shape))
        got = _info_fields(fn(dtype=dtype, params=params, **shape))
    assert got.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, str) or v is None:
            assert got[k] == v, k
        else:
            np.testing.assert_allclose(got[k], v, rtol=1e-12, err_msg=k)
    if kernel == "flash_attention":
        ref_nc = ref_fn(dtype=dtype, params=params, causal=False, **shape)
        nc = fn(dtype=dtype, params=params, causal=False, **shape)
        assert nc.mix.mxu_flops == pytest.approx(ref_nc.mix.mxu_flops,
                                              rel=1e-12)
        assert nc.mix.mxu_flops > got["mix.mxu_flops"]  # no causal discount
