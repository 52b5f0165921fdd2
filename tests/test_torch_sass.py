"""The SASS census (`repro_torch.core.sass`) and the pipeline tier's
Hopper front end (`repro_torch.core.pipeline.stream_from_sass`).

The excerpts at the bottom of this file were disassembled from the
port's own ``sm_90a`` build on an NVIDIA H100 80GB HBM3 with CUDA
12.9's ``cuobjdump -sass`` (one space per run of blanks, the encoding's
hex words dropped except on the first twelve instructions of the wgmma
kernel):

* `GEMV_F32`: the main loop of ``gemv_kernel<float, float, 4>`` (the
  split-K GEMV, csrc/gemm.cu), entered from the instruction before it;
* `STREAM_GEMV_F32`: the main loop of ``stream_gemv_kernel<float, 4,
  64, 16>`` (the gated MLP's whole-D GEMV), likewise;
* `WGMMA_BF16`: the whole of ``wgmma_kernel<__nv_bfloat16, 128, 4>``
  (the TMA + wgmma GEMM): producer and consumer loops, mbarrier spin
  waits placed out of line, the trap after the last EXIT;
* `FUNCTION_NAMES`: every function of that build (the library and the
  stencil2d and saxpy2d extensions), mangled.
"""
import dataclasses
import re

import numpy as np
import pytest

import repro_torch.kernels  # noqa: F401
from repro_torch.core import sass
from repro_torch.core.hw import H100_SXM
from repro_torch.core.isa import CLASSES, isa_table_for
from repro_torch.core.mix import InstructionMix
from repro_torch.core.pipeline import (InstructionStream, pipeline_model,
                                       simulate, stream_from_sass)
from repro_torch.examples import custom_kernel  # noqa: F401
from repro_torch.kernels import api


def _function(text: str) -> sass.SassFunction:
    return sass.parse_sass("\t\tFunction : f\n" + text)["f"]


CLASS_OF = [
    ("HGMMA.64x128x16.F32.BF16", "mxu"), ("HMMA.16816.F32.BF16", "mxu"),
    ("IMMA.16832.S8.S8", "mxu"), ("FFMA", "vpu"), ("FADD", "vpu"),
    ("FMUL", "vpu"), ("HFMA2", "vpu"), ("IMAD.WIDE", "vpu"),
    ("IADD3", "vpu"), ("LOP3.LUT", "vpu"), ("ISETP.GE.AND", "vpu"),
    ("MUFU.EX2", "trans"), ("LDG.E.128.CONSTANT", "hbm"), ("STG.E", "hbm"),
    ("RED.E.ADD.F32", "hbm"), ("ATOM.E.ADD", "hbm"),
    ("LDGSTS.E.BYPASS.128", "hbm"), ("UTMALDG.2D", "hbm"),
    ("UTMASTG.2D", "hbm"), ("UBLKCP.S.G", "hbm"), ("LDS.128", "vmem"),
    ("STS", "vmem"), ("LDSM.16.M88.4", "vmem"), ("STSM.16.M88.4", "vmem"),
    ("BRA", "ctrl"), ("BAR.SYNC.DEFER_BLOCKING", "ctrl"),
    ("SYNCS.PHASECHK.TRANS64.TRYWAIT", "ctrl"), ("WARPSYNC.ALL", "ctrl"),
    ("DEPBAR.LE", "ctrl"), ("EXIT", "ctrl"), ("MOV", "reg"),
    ("SHFL.BFLY", "reg"), ("PRMT", "reg"), ("F2F.BF16.F32", "reg"),
    ("F2FP.BF16.F32.PACK_AB", "reg"), ("S2R", "reg"), ("CS2R", "reg"),
]


@pytest.mark.parametrize("opcode,cls", CLASS_OF)
def test_the_class_table(opcode, cls):
    assert sass.sass_class(opcode) == cls
    assert cls in CLASSES


def test_every_class_row_states_its_provenance():
    assert set(sass.SASS_PROVENANCE) == set(CLASSES) - {"vpu"}
    assert all(sass.SASS_PROVENANCE.values())


def test_gemv_main_loop_census():
    fn = _function(GEMV_F32)
    assert len(fn.instructions) == 205
    (loop,) = fn.loops
    assert fn.main_loop() is loop and not loop.wait and loop.depth == 0
    body = fn.body(loop)
    ops = [i.opcode for i in body]
    # 8 warps' lanes each stream 16 rows of B: 16 16-byte loads, 4 rows
    # of A x 4 columns x 8 rows of FFMA
    assert ops.count("LDG.E.128.CONSTANT") == 16
    assert ops.count("FFMA") == 128
    c = sass.census(fn, {loop.index: 1.0}, warps=1.0)
    assert c.issued == {"mxu": 0.0, "vpu": 166.0, "trans": 0.0,
                        "hbm": 16.0, "vmem": 0.0, "ctrl": 1.0, "reg": 22.0}
    assert c.mix.hbm_bytes == 16 * 32 * 16
    assert c.loops[0]["instructions"] == 204


def test_stream_gemv_main_loop_holds_its_spin_waits():
    fn = _function(STREAM_GEMV_F32)
    main = fn.main_loop()
    assert main.depth == 0 and len(fn.body(main)) == 567
    # the panel's mbarrier waits spin inside the loop: two 3-instruction
    # loops, flagged as waits and nested one deep; a work loop beside them
    waits = [l for l in fn.loops if l.wait]
    assert [len(l.addrs) for l in waits] == [3, 3]
    assert all(l.depth == 1 and l.addrs < main.addrs for l in waits)
    assert [i.base for l in waits for i in fn.body(l)] == \
        ["YIELD", "SYNCS", "BRA"] * 2
    ops = [i.opcode for i in fn.body(main)]
    # 16 rows of W in flight a lane, streamed past L1, 4 f32 columns each
    assert ops.count("LDG.E.NA.LTC256B.128.CONSTANT") == 16
    assert ops.count("FFMA") == 304
    c = sass.census(fn, {main.index: 2.0}, warps=1.0)
    assert c.loops[main.index]["executions"] == 2.0
    assert c.loops[waits[0].index]["executions"] == 2.0


@pytest.mark.parametrize("trips,warps", [(1.0, 1.0), (10.0, 8.0),
                                         (96.5, 1536.0)])
def test_trips_scale_the_loop_body(trips, warps):
    fn = _function(GEMV_F32)
    loop = fn.main_loop()
    one = sass.census(fn, {loop.index: 1.0}, warps=1.0)
    c = sass.census(fn, {loop.index: trips}, warps=warps)
    body = len(fn.body(loop))
    assert c.instructions == pytest.approx(
        warps * (trips * body + (len(fn.instructions) - body)))
    assert c.mix.vpu_flops == pytest.approx(
        warps * trips * sum(i.units() for i in fn.body(loop)
                            if i.cls == "vpu")
        + warps * sum(i.units() for i in fn.instructions
                      if i.cls == "vpu" and not loop.contains(i.addr)))
    assert c.mix.hbm_bytes == pytest.approx(one.mix.hbm_bytes * trips
                                            * warps)


def test_wgmma_loops_and_hgmma_flops():
    fn = _function(WGMMA_BF16)
    assert len(fn.instructions) == 792
    main = fn.main_loop()
    body = fn.body(main)
    hgmma = [i for i in body if i.base == "HGMMA"]
    # one 64-deep k-block: four k16 steps of a 64 x 128 warpgroup tile
    assert [i.opcode for i in hgmma] == ["HGMMA.64x128x16.F32.BF16"] * 4
    assert hgmma[0].units() == 2 * 64 * 128 * 16 / 4
    waits = [l for l in fn.loops if l.wait]
    assert len(waits) == 2 and all(len(l.addrs) == 3 for l in waits)
    producer = [l for l in fn.loops if any(
        i.base == "UTMALDG" for i in fn.body(l)) and l.depth == 0]
    assert len(producer) == 1 and producer[0] is not main
    # the trap after the last EXIT (BRA to itself) is no loop, and an
    # out-of-line spin wait's branch back into the main loop adds none
    (trap,) = [i for i in fn.instructions
               if i.base == "BRA" and i.target() == i.addr]
    assert trap.addr > max(i.addr for i in fn.instructions
                           if i.base == "EXIT")
    assert not any(l.contains(trap.addr) for l in fn.loops)
    assert len(fn.loops) == 7
    c = sass.census(fn, {main.index: 48.0}, warps=12.0)
    assert c.mix.mxu_flops == pytest.approx(12 * 48 * 4 * 2 * 64 * 128
                                            * 16 / 4)


def test_fit_trips_reads_the_loop_off_the_row():
    fn = _function(WGMMA_BF16)
    main = fn.main_loop()
    # a 256 x 3072 x 3072 bf16 product on 128 x 128 tiles: 48 k-blocks
    # by 8 consumer warps of 12 in each of 48 blocks
    row = InstructionMix(mxu_flops=2.0 * 256 * 3072 * 3072)
    trips = sass.fit_trips(fn, row, warps=48 * 12)
    c = sass.census(fn, trips, warps=48 * 12)
    assert c.mix.mxu_flops == pytest.approx(row.mxu_flops)
    assert trips[main.index] == pytest.approx(48 * 8 / 12)
    # no work loop, no trips
    assert sass.fit_trips(_function(_STRAIGHT), row, warps=1) == {}


def test_stream_dependences_follow_register_def_use():
    fn = _function(GEMV_F32)
    loop = fn.main_loop()
    st = stream_from_sass(fn, {loop.index: 10.0}, warps=8.0)
    assert isinstance(st, InstructionStream)
    assert st.iterations == 10.0 and st.concurrency == 1.0
    assert st.ops[0].cls == "ctrl"               # the launch
    for k, op in enumerate(st.ops):
        assert op.dep is None or 0 <= op.dep < k
    # the loads read the addresses an integer run computed (the rows
    # they load feed the next pass's FFMAs: carried by the loop, not a
    # dependence within one pass)
    assert any(op.cls == "hbm" and op.dep is not None
               and st.ops[op.dep].cls == "vpu" for op in st.ops)
    wg = _function(WGMMA_BF16)
    wst = stream_from_sass(wg, {wg.main_loop().index: 4.0}, warps=12.0)
    # the MMAs wait on the descriptors moved to uniform registers
    assert any(op.cls == "mxu" and op.dep is not None for op in wst.ops)
    # units: the body's per-warp units times the warps, per pass
    body = sum(i.units() for i in fn.body(loop) if i.cls == "hbm")
    in_loop = [op for op in st.ops[1:] if op.cls == "hbm"]
    assert sum(op.units for op in in_loop) == pytest.approx(8.0 * body)


def test_the_def_use_of_one_instruction():
    fn = _function(WGMMA_BF16)
    i = next(i for i in fn.instructions if i.base == "HGMMA")
    dst, src = i.regs()
    assert dst[0] == "R24" and len(dst) == 64      # 64 x 128 f32 / 128
    assert "UR8" in src or any(r.startswith("UR") for r in src)
    ldg = next(i for i in _function(GEMV_F32).instructions
               if i.base == "LDG")
    assert ldg.opcode == "LDG.E.128.CONSTANT"
    dst, src = ldg.regs()
    first = int(dst[0][1:])
    assert dst == tuple(f"R{first + k}" for k in range(4))
    assert src and all(r.startswith(("R", "UR")) for r in src)


def test_stream_from_sass_prices_on_the_hopper_table():
    fn = _function(WGMMA_BF16)
    main = fn.main_loop()
    st = stream_from_sass(fn, {main.index: 32.0}, warps=576.0,
                          tma_bytes=3.0e7)
    assert {op.cls for op in st.ops} <= set(CLASSES)
    assert sum(op.units for op in st.ops if op.cls == "mxu") * 32.0 == \
        pytest.approx(576 * 32 * 4 * 2 * 64 * 128 * 16 / 4)
    stated = sass.census(fn, {main.index: 32.0}, warps=576.0).mix.hbm_bytes
    assert sum(op.units for op in st.ops if op.cls == "hbm") * 32.0 == \
        pytest.approx(3.0e7 + stated)
    res = simulate(st, isa_table_for(H100_SXM), saturation=64)
    assert res.seconds > 0 and res.iterations == 32.0


def test_control_bits_of_the_encoding():
    fn = _function(WGMMA_BF16)
    first = fn.instructions[0]
    assert first.opcode == "LDC"
    # 0x000e300000000800: stall 8, result scoreboard 0, no read barrier
    assert (first.stall, first.wbar, first.rbar, first.wait) == (8, 0, -1, 0)
    assert all(i.stall is not None for i in fn.instructions[:12])
    assert all(i.stall is None for i in fn.instructions[12:])


def test_resources_and_spills_from_cuobjdump():
    text = (" Function f:\n  REG:154 STACK:8 SHARED:1024 LOCAL:16 "
            "CONSTANT[0]:852 TEXTURE:0 SURFACE:0 SAMPLER:0\n"
            "\t\tFunction : f\n" + _STRAIGHT)
    fn = sass.parse_sass(text, {"f": "void f<(int)1>()"})["f"]
    assert (fn.regs, fn.stack, fn.shared, fn.local) == (154, 8, 1024, 16)
    assert fn.demangled == "void f<(int)1>()"
    assert (fn.spill_stores, fn.spill_loads) == (1, 1)
    assert fn.blocks() == [(0x0, 0x40)]


def test_nvdisasm_labels_resolve():
    text = """\
\t.text.k:
        /*0000*/                   MOV R0, RZ ;
.L_x_0:
        /*0010*/                   LDG.E R2, desc[UR4][R4.64] ;
        /*0020*/                   FFMA R0, R2, R2, R0 ;
        /*0030*/                   ISETP.NE.AND P0, PT, R0, RZ, PT ;
        /*0040*/               @P0 BRA `(.L_x_0) ;
        /*0050*/                   EXIT ;
"""
    fn = sass.parse_sass(text)["k"]
    (loop,) = fn.loops
    assert loop.head == 0x10 and sorted(loop.addrs) == [0x10, 0x20, 0x30,
                                                        0x40]
    assert fn.blocks() == [(0x0, 0x0), (0x10, 0x40), (0x50, 0x50)]


MANGLED = [
    (("gemm_kernel", "bfloat16", "bfloat16", 16, 64, 32, 1, 4),
     "_Z11gemm_kernelI13__nv_bfloat16S0_Li16ELi64ELi32ELi1ELi4EE"),
    (("gemv_kernel", "bfloat16", "float32", 4),
     "_Z11gemv_kernelI13__nv_bfloat16fLi4EE"),
    (("gated_wgmma_kernel", 128, 4), "_Z18gated_wgmma_kernelILi128ELi4EE"),
    (("wgmma_kernel", "float32", 256, 4), "_Z12wgmma_kernelIfLi256ELi4EE"),
]


@pytest.mark.parametrize("args,want", MANGLED)
def test_template_symbols(args, want):
    assert sass.template_symbol(*args) == want


SIGS = {"matmul": dict(m=4, n=3072, k=24576),
        "mlp_matmul": dict(m=4, d=3072, f=24576, act="gelu"),
        "rms_norm": dict(m=4, d=3072),
        "flash_attention": dict(b=4, h=16, sq=64, skv=64, d=256,
                                causal=True),
        "matvec": dict(m=8192, n=8192), "atax": dict(m=8192, n=8192),
        "bicg": dict(m=8192, n=8192), "jacobi3d": dict(z=256, y=256, x=256),
        "stencil2d": dict(y=8192, x=8192), "saxpy2d": dict(m=8192, n=8192)}


@pytest.mark.parametrize("kernel", sorted(SIGS))
def test_every_row_names_a_function_of_the_build(kernel):
    names = FUNCTION_NAMES.split()
    spec = api.get_spec(kernel)
    for vid, h in spec._hopper.items():
        assert h.symbols is not None
        for tile in h.tiles:
            for dt in ("float32", "bfloat16"):
                p = {"tile": tile} if vid is None else {"variant": vid,
                                                        "tile": tile}
                syms = spec.sass_symbols(p, dtype=dt, **SIGS[kernel])
                assert syms
                for sym in syms:
                    hits = [n for n in names if n.startswith(sym)]
                    assert len(hits) == 1, (kernel, tile, dt, sym)


def test_a_row_read_from_the_disassembly():
    funcs = {"_Z12wgmma_kernelI13__nv_bfloat16Li128ELi4EEv14CUtensorMap_"
             "stS1_PT_iii": _function(WGMMA_BF16)}
    spec = api.get_spec("matmul")
    sig = dict(m=256, n=3072, k=3072, dtype="bfloat16")
    row = spec.sass_row({"tile": "wgmma_n128s1"}, funcs, **sig)
    # 2 x 24 blocks of 384 threads
    assert row.warps == 48 * 12
    assert row.census.mix.mxu_flops == pytest.approx(2.0 * 256 * 3072
                                                     * 3072)
    # the epilogue's stores state their width; the TMA loads bring the
    # rest of the row's device bytes
    assert 0 < row.tma_bytes < row.info.mix.hbm_bytes
    assert row.census.mix.hbm_bytes == pytest.approx(row.info.mix.hbm_bytes)
    st = row.stream()
    assert st.concurrency == row.info.hopper.active_warps
    with pytest.raises(KeyError, match="no SASS function"):
        spec.sass_row({"tile": "wgmma_n256s1"}, funcs, **sig)


def test_use_sass_gives_the_pipeline_tier_its_own_model():
    from repro_torch.tuning_cache import registry
    funcs = {"_Z12wgmma_kernelI13__nv_bfloat16Li128ELi4EEv14CUtensorMap_"
             "stS1_PT_iii": _function(WGMMA_BF16)}
    plain = registry._model_for(H100_SXM, "pipeline")
    with sass.use_sass(funcs):
        read = registry._model_for(H100_SXM, "pipeline")
        assert read.fingerprint() != plain.fingerprint()
        assert registry._model_for(H100_SXM, "eq6") is \
            registry._model_for(H100_SXM, "eq6")
        problem = api.get_spec("matmul")._hopper_problem(
            H100_SXM, dict(m=256, n=3072, k=3072, dtype="bfloat16"))
        st = problem.schedule({"tile": "wgmma_n128s1"})
        assert isinstance(st, InstructionStream)
    assert registry._model_for(H100_SXM, "pipeline") is plain
    assert api.get_spec("matmul")._hopper_problem(
        H100_SXM, dict(m=256, n=3072, k=3072, dtype="bfloat16")
    ).schedule is None


def test_a_missing_tool_raises(tmp_path, monkeypatch):
    from repro_torch.kernels import _cuda
    (tmp_path / "nvcc").write_text("")
    monkeypatch.setattr(_cuda, "_nvcc", lambda: str(tmp_path / "nvcc"))
    for tool in ("cuobjdump", "cu++filt"):
        with pytest.raises(RuntimeError,
                           match=re.escape(f"{tool} not found")):
            _cuda._toolkit(tool)
    lib = tmp_path / "librepro_torch_x.so"
    lib.write_bytes(b"")
    monkeypatch.setattr(_cuda, "_binary", lambda ext: lib)
    with pytest.raises(RuntimeError, match="cuobjdump not found"):
        _cuda.disassemble()


_STRAIGHT = """\
/*0000*/ S2R R0, SR_TID.X ;
/*0010*/ STL [R1], R0 ;
/*0020*/ LDL R2, [R1] ;
/*0030*/ STG.E desc[UR4][R4.64], R2 ;
/*0040*/ EXIT ;
"""

# ---------------------------------------------------------------------------
# captured on the card (see the module docstring)
# ---------------------------------------------------------------------------

GEMV_F32 = """\
/*0450*/ SHF.R.S32.HI R3, RZ, 0x1f, R2 ;
/*0460*/ ISETP.GE.AND P4, PT, R89, 0x1, PT ;
/*0470*/ IMAD.U32 R95, RZ, RZ, UR8 ;
/*0480*/ ISETP.GE.AND P3, PT, R68.reuse, 0x2, PT ;
/*0490*/ CS2R R10, SRZ ;
/*04a0*/ ISETP.GE.AND P2, PT, R68.reuse, 0x3, PT ;
/*04b0*/ CS2R R14, SRZ ;
/*04c0*/ ISETP.GE.AND P1, PT, R68, 0x4, PT ;
/*04d0*/ CS2R R12, SRZ ;
/*04e0*/ SHF.R.S32.HI R5, RZ, 0x1f, R97 ;
/*04f0*/ MOV R69, UR7 ;
/*0500*/ @P4 LDC.64 R56, c[0x0][0x210] ;
/*0510*/ IMAD R4, R5, R69.reuse, RZ ;
/*0520*/ IMAD.WIDE.U32 R6, R97, R69, R2 ;
/*0530*/ @P3 LDC.64 R58, c[0x0][0x210] ;
/*0540*/ IMAD R9, R97, R96, R4 ;
/*0550*/ MOV R4, R97 ;
/*0560*/ LEA R28, P5, R6.reuse, UR4, 0x2 ;
/*0570*/ IMAD.IADD R7, R7, 0x1, R9 ;
/*0580*/ IMAD.WIDE R4, R95, UR6, R4 ;
/*0590*/ @P2 LDC.64 R90, c[0x0][0x210] ;
/*05a0*/ LEA.HI.X R29, R6, UR5, R7, 0x2, P5 ;
/*05b0*/ IADD3 R6, P6, R4, R95, RZ ;
/*05c0*/ @P1 LDC.64 R92, c[0x0][0x210] ;
/*05d0*/ @P4 LEA R56, P5, R4.reuse, R56, 0x2 ;
/*05e0*/ IMAD.WIDE R42, R69, 0x4, R28 ;
/*05f0*/ IADD3.X R7, R5, R86, RZ, P6, !PT ;
/*0600*/ CS2R R22, SRZ ;
/*0610*/ @P4 LEA.HI.X R57, R4, R57, R5, 0x2, P5 ;
/*0620*/ CS2R R20, SRZ ;
/*0630*/ IADD3 R8, P6, R6.reuse, R95, RZ ;
/*0640*/ IMAD.WIDE R44, R69, 0x4, R42 ;
/*0650*/ @P3 LEA R58, P5, R6, R58, 0x2 ;
/*0660*/ LDG.E.128.CONSTANT R16, desc[UR10][R28.64] ;
/*0670*/ IMAD.X R5, R86, 0x1, R7.reuse, P6 ;
/*0680*/ @P3 LEA.HI.X R59, R6, R59, R7, 0x2, P5 ;
/*0690*/ CS2R R6, SRZ ;
/*06a0*/ @P1 IADD3 R4, P6, R8.reuse, R95, RZ ;
/*06b0*/ LDG.E.128.CONSTANT R24, desc[UR10][R42.64] ;
/*06c0*/ @P2 LEA R90, P5, R8.reuse, R90, 0x2 ;
/*06d0*/ IMAD.WIDE R46, R69, 0x4, R44 ;
/*06e0*/ LDG.E.128.CONSTANT R28, desc[UR10][R44.64] ;
/*06f0*/ @P2 LEA.HI.X R91, R8, R91, R5, 0x2, P5 ;
/*0700*/ CS2R R8, SRZ ;
/*0710*/ @P1 IADD3.X R5, R86, R5, RZ, P6, !PT ;
/*0720*/ IMAD.WIDE R60, R69, 0x4, R46 ;
/*0730*/ @P1 LEA R92, P5, R4.reuse, R92, 0x2 ;
/*0740*/ @P2 LDG.E.128.CONSTANT R12, desc[UR10][R90.64] ;
/*0750*/ @P1 LEA.HI.X R93, R4, R93, R5, 0x2, P5 ;
/*0760*/ CS2R R4, SRZ ;
/*0770*/ @P3 LDG.E.128.CONSTANT R8, desc[UR10][R58.64] ;
/*0780*/ @P1 LDG.E.128.CONSTANT R20, desc[UR10][R92.64] ;
/*0790*/ @P4 LDG.E.128.CONSTANT R4, desc[UR10][R56.64] ;
/*07a0*/ CS2R R36, SRZ ;
/*07b0*/ CS2R R38, SRZ ;
/*07c0*/ CS2R R40, SRZ ;
/*07d0*/ CS2R R42, SRZ ;
/*07e0*/ CS2R R48, SRZ ;
/*07f0*/ CS2R R50, SRZ ;
/*0800*/ CS2R R52, SRZ ;
/*0810*/ CS2R R54, SRZ ;
/*0820*/ IMAD.WIDE R98, R69.reuse, 0x4, R60 ;
/*0830*/ LDG.E.128.CONSTANT R32, desc[UR10][R46.64] ;
/*0840*/ @P4 LDG.E.128.CONSTANT R36, desc[UR10][R56.64+0x10] ;
/*0850*/ IMAD.WIDE R100, R69, 0x4, R98 ;
/*0860*/ @P3 LDG.E.128.CONSTANT R40, desc[UR10][R58.64+0x10] ;
/*0870*/ LDG.E.128.CONSTANT R44, desc[UR10][R60.64] ;
/*0880*/ @P2 LDG.E.128.CONSTANT R48, desc[UR10][R90.64+0x10] ;
/*0890*/ @P1 LDG.E.128.CONSTANT R52, desc[UR10][R92.64+0x10] ;
/*08a0*/ IMAD.WIDE R64, R69, 0x4, R100 ;
/*08b0*/ LDG.E.128.CONSTANT R56, desc[UR10][R98.64] ;
/*08c0*/ LDG.E.128.CONSTANT R60, desc[UR10][R100.64] ;
/*08d0*/ LDG.E.128.CONSTANT R64, desc[UR10][R64.64] ;
/*08e0*/ VIADD R103, R97, 0x48 ;
/*08f0*/ ISETP.GT.AND P1, PT, R103, R82, PT ;
/*0900*/ IADD3 R97, R97, 0x40, RZ ;
/*0910*/ FFMA R75, R16, R12.reuse, R75 ;
/*0920*/ FFMA R72, R17, R12.reuse, R72 ;
/*0930*/ FFMA R73, R18, R12.reuse, R73 ;
/*0940*/ FFMA R12, R19, R12, R70 ;
/*0950*/ FFMA R79, R16, R8.reuse, R79 ;
/*0960*/ FFMA R76, R17, R8.reuse, R76 ;
/*0970*/ FFMA R77, R18, R8.reuse, R77 ;
/*0980*/ FFMA R8, R19, R8, R74 ;
/*0990*/ FFMA R71, R16, R20.reuse, R71 ;
/*09a0*/ FFMA R0, R17, R20.reuse, R0 ;
/*09b0*/ FFMA R87, R18, R20.reuse, R87 ;
/*09c0*/ FFMA R20, R19, R20, R88 ;
/*09d0*/ FFMA R83, R16, R4.reuse, R83 ;
/*09e0*/ FFMA R80, R17, R4.reuse, R80 ;
/*09f0*/ FFMA R81, R18, R4.reuse, R81 ;
/*0a00*/ FFMA R4, R19, R4, R78 ;
/*0a10*/ FFMA R83, R24, R5.reuse, R83 ;
/*0a20*/ FFMA R80, R25, R5.reuse, R80 ;
/*0a30*/ FFMA R81, R26, R5.reuse, R81 ;
/*0a40*/ FFMA R4, R27, R5, R4 ;
/*0a50*/ FFMA R79, R24, R9.reuse, R79 ;
/*0a60*/ FFMA R76, R25, R9.reuse, R76 ;
/*0a70*/ FFMA R77, R26, R9.reuse, R77 ;
/*0a80*/ FFMA R8, R27, R9, R8 ;
/*0a90*/ FFMA R75, R24, R13.reuse, R75 ;
/*0aa0*/ FFMA R72, R25, R13.reuse, R72 ;
/*0ab0*/ FFMA R73, R26, R13.reuse, R73 ;
/*0ac0*/ FFMA R12, R27, R13, R12 ;
/*0ad0*/ FFMA R71, R24, R21.reuse, R71 ;
/*0ae0*/ FFMA R0, R25, R21.reuse, R0 ;
/*0af0*/ FFMA R87, R26, R21.reuse, R87 ;
/*0b00*/ FFMA R20, R27, R21, R20 ;
/*0b10*/ FFMA R83, R28, R6.reuse, R83 ;
/*0b20*/ FFMA R80, R29, R6.reuse, R80 ;
/*0b30*/ FFMA R81, R30, R6.reuse, R81 ;
/*0b40*/ FFMA R4, R31, R6, R4 ;
/*0b50*/ FFMA R79, R28, R10.reuse, R79 ;
/*0b60*/ FFMA R76, R29, R10.reuse, R76 ;
/*0b70*/ FFMA R77, R30, R10.reuse, R77 ;
/*0b80*/ FFMA R8, R31, R10, R8 ;
/*0b90*/ FFMA R75, R28, R14.reuse, R75 ;
/*0ba0*/ FFMA R72, R29, R14.reuse, R72 ;
/*0bb0*/ FFMA R73, R30, R14.reuse, R73 ;
/*0bc0*/ FFMA R12, R31, R14, R12 ;
/*0bd0*/ FFMA R71, R28, R22.reuse, R71 ;
/*0be0*/ FFMA R0, R29, R22.reuse, R0 ;
/*0bf0*/ FFMA R87, R30, R22.reuse, R87 ;
/*0c00*/ FFMA R20, R31, R22, R20 ;
/*0c10*/ FFMA R83, R32, R7.reuse, R83 ;
/*0c20*/ FFMA R80, R33, R7.reuse, R80 ;
/*0c30*/ FFMA R81, R34, R7.reuse, R81 ;
/*0c40*/ FFMA R4, R35, R7, R4 ;
/*0c50*/ FFMA R79, R32, R11.reuse, R79 ;
/*0c60*/ FFMA R76, R33, R11.reuse, R76 ;
/*0c70*/ FFMA R77, R34, R11.reuse, R77 ;
/*0c80*/ FFMA R8, R35, R11, R8 ;
/*0c90*/ FFMA R75, R32, R15.reuse, R75 ;
/*0ca0*/ FFMA R72, R33, R15.reuse, R72 ;
/*0cb0*/ FFMA R73, R34, R15.reuse, R73 ;
/*0cc0*/ FFMA R12, R35, R15, R12 ;
/*0cd0*/ FFMA R71, R32, R23.reuse, R71 ;
/*0ce0*/ FFMA R0, R33, R23.reuse, R0 ;
/*0cf0*/ FFMA R87, R34, R23.reuse, R87 ;
/*0d00*/ FFMA R20, R35, R23, R20 ;
/*0d10*/ FFMA R83, R44, R36.reuse, R83 ;
/*0d20*/ FFMA R80, R45, R36.reuse, R80 ;
/*0d30*/ FFMA R81, R46, R36.reuse, R81 ;
/*0d40*/ FFMA R4, R47, R36, R4 ;
/*0d50*/ FFMA R79, R44, R40.reuse, R79 ;
/*0d60*/ FFMA R76, R45, R40.reuse, R76 ;
/*0d70*/ FFMA R77, R46, R40.reuse, R77 ;
/*0d80*/ FFMA R8, R47, R40, R8 ;
/*0d90*/ FFMA R75, R44, R48.reuse, R75 ;
/*0da0*/ FFMA R72, R45, R48.reuse, R72 ;
/*0db0*/ FFMA R73, R46, R48.reuse, R73 ;
/*0dc0*/ FFMA R12, R47, R48, R12 ;
/*0dd0*/ FFMA R71, R44, R52.reuse, R71 ;
/*0de0*/ FFMA R0, R45, R52.reuse, R0 ;
/*0df0*/ FFMA R87, R46, R52.reuse, R87 ;
/*0e00*/ FFMA R20, R47, R52, R20 ;
/*0e10*/ FFMA R83, R56, R37.reuse, R83 ;
/*0e20*/ FFMA R80, R57, R37.reuse, R80 ;
/*0e30*/ FFMA R81, R58, R37.reuse, R81 ;
/*0e40*/ FFMA R4, R59, R37, R4 ;
/*0e50*/ FFMA R79, R56, R41.reuse, R79 ;
/*0e60*/ FFMA R76, R57, R41.reuse, R76 ;
/*0e70*/ FFMA R77, R58, R41.reuse, R77 ;
/*0e80*/ FFMA R8, R59, R41, R8 ;
/*0e90*/ FFMA R75, R56, R49.reuse, R75 ;
/*0ea0*/ FFMA R72, R57, R49.reuse, R72 ;
/*0eb0*/ FFMA R73, R58, R49.reuse, R73 ;
/*0ec0*/ FFMA R12, R59, R49, R12 ;
/*0ed0*/ FFMA R71, R56, R53.reuse, R71 ;
/*0ee0*/ FFMA R0, R57, R53.reuse, R0 ;
/*0ef0*/ FFMA R87, R58, R53.reuse, R87 ;
/*0f00*/ FFMA R20, R59, R53, R20 ;
/*0f10*/ FFMA R83, R60, R38.reuse, R83 ;
/*0f20*/ FFMA R80, R61, R38.reuse, R80 ;
/*0f30*/ FFMA R81, R62, R38.reuse, R81 ;
/*0f40*/ FFMA R4, R63, R38, R4 ;
/*0f50*/ FFMA R79, R60, R42.reuse, R79 ;
/*0f60*/ FFMA R76, R61, R42.reuse, R76 ;
/*0f70*/ FFMA R77, R62, R42.reuse, R77 ;
/*0f80*/ FFMA R8, R63, R42, R8 ;
/*0f90*/ FFMA R75, R60, R50.reuse, R75 ;
/*0fa0*/ FFMA R72, R61, R50.reuse, R72 ;
/*0fb0*/ FFMA R73, R62, R50.reuse, R73 ;
/*0fc0*/ FFMA R12, R63, R50, R12 ;
/*0fd0*/ FFMA R71, R60, R54.reuse, R71 ;
/*0fe0*/ FFMA R0, R61, R54.reuse, R0 ;
/*0ff0*/ FFMA R87, R62, R54.reuse, R87 ;
/*1000*/ FFMA R20, R63, R54, R20 ;
/*1010*/ FFMA R83, R64, R39.reuse, R83 ;
/*1020*/ FFMA R80, R65, R39.reuse, R80 ;
/*1030*/ FFMA R81, R66, R39.reuse, R81 ;
/*1040*/ FFMA R78, R67, R39, R4 ;
/*1050*/ FFMA R79, R64, R43.reuse, R79 ;
/*1060*/ FFMA R76, R65, R43.reuse, R76 ;
/*1070*/ FFMA R77, R66, R43.reuse, R77 ;
/*1080*/ FFMA R74, R67, R43, R8 ;
/*1090*/ FFMA R75, R64, R51.reuse, R75 ;
/*10a0*/ FFMA R72, R65, R51.reuse, R72 ;
/*10b0*/ FFMA R73, R66, R51.reuse, R73 ;
/*10c0*/ FFMA R70, R67, R51, R12 ;
/*10d0*/ FFMA R71, R64, R55.reuse, R71 ;
/*10e0*/ FFMA R0, R65, R55.reuse, R0 ;
/*10f0*/ FFMA R87, R66, R55.reuse, R87 ;
/*1100*/ FFMA R88, R67, R55, R20 ;
/*1110*/ @!P1 BRA 0x460 ;
"""

STREAM_GEMV_F32 = """\
/*1790*/ SHF.R.S32.HI R91, RZ, 0x1f, R91 ;
/*17a0*/ S2R R13, SR_TID.X ;
/*17b0*/ LDC R49, c[0x0][0x234] ;
/*17c0*/ IMAD R6, R91, R88, RZ ;
/*17d0*/ ULDC UR5, c[0x0][0x240] ;
/*17e0*/ S2R R11, SR_CTAID.X ;
/*17f0*/ MOV R67, 0x400 ;
/*1800*/ USHF.L.U32 UR8, UR6, 0x2, URZ ;
/*1810*/ ISETP.LT.AND P2, PT, R86, R3, PT ;
/*1820*/ S2R R64, SR_CgaCtaId ;
/*1830*/ LDC.64 R8, c[0x0][0x218] ;
/*1840*/ IADD3 R65, R67, 0x10, RZ ;
/*1850*/ BSSY B1, 0x3ab0 ;
/*1860*/ LDC R76, c[0x0][0x238] ;
/*1870*/ IMAD R7, R89, R49, R6 ;
/*1880*/ SHF.R.U32.HI R5, RZ, 0x7, R13 ;
/*1890*/ SHF.L.U32 R4, R13, 0x2, RZ ;
/*18a0*/ ISETP.NE.AND P0, PT, R5, RZ, PT ;
/*18b0*/ LOP3.LUT R10, R4, 0x3c, RZ, 0xc0, !PT ;
/*18c0*/ IMAD.WIDE.U32 R4, R88, R49, RZ ;
/*18d0*/ LEA R65, R64, R65, 0x18 ;
/*18e0*/ LOP3.LUT R21, RZ, R76, RZ, 0x33, !PT ;
/*18f0*/ IMAD R10, R11, 0x40, R10 ;
/*1900*/ IADD3 R5, R5, R7, RZ ;
/*1910*/ IMAD R93, R86, 0x40, R65 ;
/*1920*/ SHF.R.S32.HI R11, RZ, 0x1f, R10 ;
/*1930*/ @P0 LDC R8, c[0x0][0x220] ;
/*1940*/ LEA R6, P1, R4, R10, 0x7 ;
/*1950*/ IADD3 R16, R10, 0x4, RZ ;
/*1960*/ LEA.HI.X R7, R4, R11, R5, 0x7, P1 ;
/*1970*/ SHF.L.U32 R4, R0, 0x5, RZ ;
/*1980*/ @P0 LDC R9, c[0x0][0x224] ;
/*1990*/ ISETP.NE.AND P0, PT, RZ, UR5, PT ;
/*19a0*/ LOP3.LUT R5, R13, 0x10, RZ, 0xc0, !PT ;
/*19b0*/ LOP3.LUT R12, R4, 0x10, R13, 0xf8, !PT ;
/*19c0*/ ISETP.LE.AND P0, PT, R16, R49.reuse, P0 ;
/*19d0*/ IADD3 R14, -R4, -0x11, -R5 ;
/*19e0*/ IMAD.WIDE.U32 R4, R12, R49, R6 ;
/*19f0*/ MOV R13, UR8 ;
/*1a00*/ IMAD R7, R91, R12, RZ ;
/*1a10*/ LOP3.LUT R12, R13, 0xffffffc0, RZ, 0xc0, !PT ;
/*1a20*/ IMAD R6, R87, -0x80, R14 ;
/*1a30*/ LEA R18, P1, R4, R8, 0x2 ;
/*1a40*/ IADD3 R5, R5, R7, RZ ;
/*1a50*/ VIMNMX R21, R21, R6, !PT ;
/*1a60*/ IADD3 R93, R12, R93, RZ ;
/*1a70*/ LEA.HI.X R19, R4, R9, R5, 0x2, P1 ;
/*1a80*/ SHF.L.U32 R14, R86, 0x4, RZ ;
/*1a90*/ IADD3 R22, R6, 0xf, RZ ;
/*1aa0*/ IADD3 R4, -R21, 0x1, RZ ;
/*1ab0*/ @P0 BRA P2, 0x26a0 ;
/*1ac0*/ LOP3.LUT P1, RZ, R85, 0xff, RZ, 0xc0, !PT ;
/*1ad0*/ BSSY B2, 0x1b50 ;
/*1ae0*/ @P1 BRA 0x1b40 ;
/*1af0*/ LEA R64, R64, R67, 0x18 ;
/*1b00*/ YIELD ;
/*1b10*/ SYNCS.PHASECHK.TRANS64.TRYWAIT P1, [R64+URZ], RZ ;
/*1b20*/ @!P1 BRA 0x1b00 ;
/*1b30*/ HFMA2.MMA R85, -RZ, RZ, 0, 5.9604644775390625e-08 ;
/*1b40*/ BSYNC B2 ;
/*1b50*/ VIADDMNMX R12, R14.reuse, 0x10, R76, PT ;
/*1b60*/ BSSY B2, 0x2690 ;
/*1b70*/ ISETP.GE.AND P1, PT, R14, R12, PT ;
/*1b80*/ @P1 BRA 0x2680 ;
/*1b90*/ LOP3.LUT R4, R4, 0x1, RZ, 0xc0, !PT ;
/*1ba0*/ BSSY B3, 0x1f30 ;
/*1bb0*/ ISETP.NE.U32.AND P1, PT, R4, 0x1, PT ;
/*1bc0*/ @P1 BRA 0x1f20 ;
/*1bd0*/ BSSY B4, 0x1d80 ;
/*1be0*/ @P0 BRA 0x1d10 ;
/*1bf0*/ VIADD R4, R10.reuse, 0x1 ;
/*1c00*/ IADD3 R6, R10.reuse, 0x2, RZ ;
/*1c10*/ ISETP.GE.AND P1, PT, R10, R49.reuse, PT ;
/*1c20*/ ISETP.GE.AND P2, PT, R4, R49.reuse, PT ;
/*1c30*/ CS2R R4, SRZ ;
/*1c40*/ ISETP.GE.AND P3, PT, R6, R49, PT ;
/*1c50*/ CS2R R6, SRZ ;
/*1c60*/ @!P1 IMAD.WIDE R14, R14, R49, R10 ;
/*1c70*/ @!P2 LDG.E R5, desc[UR12][R18.64+0x4] ;
/*1c80*/ @!P1 LEA R16, P4, R14, R8, 0x2 ;
/*1c90*/ @!P3 LDG.E R6, desc[UR12][R18.64+0x8] ;
/*1ca0*/ @!P1 LEA.HI.X R17, R14, R9, R15, 0x2, P4 ;
/*1cb0*/ IADD3 R14, R10, 0x3, RZ ;
/*1cc0*/ @!P1 LDG.E R4, desc[UR12][R16.64] ;
/*1cd0*/ ISETP.GE.AND P1, PT, R14, R49, PT ;
/*1ce0*/ @P1 BRA 0x1d70 ;
/*1cf0*/ LDG.E R7, desc[UR12][R18.64+0xc] ;
/*1d00*/ BRA 0x1d70 ;
/*1d10*/ MOV R4, R10 ;
/*1d20*/ MOV R5, R11 ;
/*1d30*/ IMAD.WIDE R14, R14, R49, R4 ;
/*1d40*/ LEA R4, P1, R14, R8, 0x2 ;
/*1d50*/ LEA.HI.X R5, R14, R9, R15, 0x2, P1 ;
/*1d60*/ LDG.E.128.CONSTANT R4, desc[UR12][R4.64] ;
/*1d70*/ BSYNC B4 ;
/*1d80*/ LEA R15, R76, 0x3c, 0x2 ;
/*1d90*/ VIADD R13, R93, UR7 ;
/*1da0*/ LEA R14, R86, R65, 0x6 ;
/*1db0*/ LDS R16, [R93] ;
/*1dc0*/ LOP3.LUT R18, R15, 0xffffffc0, RZ, 0xc0, !PT ;
/*1dd0*/ IADD3 R13, R13, R18, RZ ;
/*1de0*/ LDS R14, [R14] ;
/*1df0*/ LDS R18, [R93+UR7] ;
/*1e00*/ LDS R20, [R13] ;
/*1e10*/ FFMA R97, R16.reuse, R4, R97 ;
/*1e20*/ FFMA R96, R16.reuse, R5, R96 ;
/*1e30*/ FFMA R99, R16.reuse, R6, R99 ;
/*1e40*/ FFMA R98, R16, R7, R98 ;
/*1e50*/ FFMA R61, R14.reuse, R4, R61 ;
/*1e60*/ FFMA R60, R14.reuse, R5, R60 ;
/*1e70*/ FFMA R63, R14.reuse, R6, R63 ;
/*1e80*/ FFMA R62, R14, R7, R62 ;
/*1e90*/ FFMA R101, R18.reuse, R4, R101 ;
/*1ea0*/ FFMA R100, R18.reuse, R5, R100 ;
/*1eb0*/ FFMA R103, R18.reuse, R6, R103 ;
/*1ec0*/ FFMA R102, R18, R7, R102 ;
/*1ed0*/ FFMA R95, R20.reuse, R4, R95 ;
/*1ee0*/ FFMA R104, R20.reuse, R5, R104 ;
/*1ef0*/ FFMA R105, R20.reuse, R6, R105 ;
/*1f00*/ FFMA R106, R20, R7, R106 ;
/*1f10*/ LEA R14, R86, 0x1, 0x4 ;
/*1f20*/ BSYNC B3 ;
/*1f30*/ ISETP.NE.AND P1, PT, R22, R21, PT ;
/*1f40*/ @!P1 BRA 0x2680 ;
/*1f50*/ LDC R25, c[0x0][0x234] ;
/*1f60*/ LEA R76, R76, 0x3c, 0x2 ;
/*1f70*/ LOP3.LUT R76, R76, 0xffffffc0, RZ, 0xc0, !PT ;
/*1f80*/ SHF.R.S32.HI R4, RZ, 0x1f, R14 ;
/*1f90*/ BSSY B3, 0x2180 ;
/*1fa0*/ IMAD R6, R4, R25.reuse, RZ ;
/*1fb0*/ IMAD.WIDE.U32 R4, R14, R25, RZ ;
/*1fc0*/ IMAD R7, R14, R91, R6 ;
/*1fd0*/ IADD3 R7, R5, R7, RZ ;
/*1fe0*/ @P0 BRA 0x2120 ;
/*1ff0*/ IADD3 R6, R10.reuse, 0x1, RZ ;
/*2000*/ IADD3 R16, R10.reuse, 0x2, RZ ;
/*2010*/ IADD3 R4, P1, R10, R4, RZ ;
/*2020*/ ISETP.GE.AND P3, PT, R6, R25.reuse, PT ;
/*2030*/ ISETP.GE.AND P2, PT, R10, R25.reuse, PT ;
/*2040*/ ISETP.GE.AND P4, PT, R16, R25, PT ;
/*2050*/ IADD3.X R5, R11, R7, RZ, P1, !PT ;
/*2060*/ CS2R R6, SRZ ;
/*2070*/ LEA R16, P1, R4, R8, 0x2 ;
/*2080*/ LEA.HI.X R17, R4, R9, R5, 0x2, P1 ;
/*2090*/ CS2R R4, SRZ ;
/*20a0*/ @!P4 LDG.E R6, desc[UR12][R16.64+0x8] ;
/*20b0*/ @!P2 LDG.E R4, desc[UR12][R16.64] ;
/*20c0*/ @!P3 LDG.E R5, desc[UR12][R16.64+0x4] ;
/*20d0*/ VIADD R18, R10, 0x3 ;
/*20e0*/ ISETP.GE.AND P1, PT, R18, R25, PT ;
/*20f0*/ @P1 BRA 0x2170 ;
/*2100*/ LDG.E R7, desc[UR12][R16.64+0xc] ;
/*2110*/ BRA 0x2170 ;
/*2120*/ IADD3 R5, P1, R10, R4, RZ ;
/*2130*/ IADD3.X R6, R11, R7, RZ, P1, !PT ;
/*2140*/ LEA R4, P1, R5, R8, 0x2 ;
/*2150*/ LEA.HI.X R5, R5, R9, R6, 0x2, P1 ;
/*2160*/ LDG.E.128.CONSTANT R4, desc[UR12][R4.64] ;
/*2170*/ BSYNC B3 ;
/*2180*/ LEA R15, R14.reuse, R65, 0x2 ;
/*2190*/ VIADD R24, R14, 0x1 ;
/*21a0*/ BSSY B3, 0x2510 ;
/*21b0*/ IADD3 R19, R76.reuse, R15, RZ ;
/*21c0*/ LDS R16, [R15] ;
/*21d0*/ SHF.R.S32.HI R13, RZ, 0x1f, R24 ;
/*21e0*/ IADD3 R21, R76.reuse, R19, RZ ;
/*21f0*/ LDS R18, [R19] ;
/*2200*/ IMAD R13, R13, R25, RZ ;
/*2210*/ IADD3 R23, R76, R21, RZ ;
/*2220*/ LDS R20, [R21] ;
/*2230*/ IMAD R13, R24, R91, R13 ;
/*2240*/ LDS R22, [R23] ;
/*2250*/ FFMA R61, R16.reuse, R4, R61 ;
/*2260*/ FFMA R60, R16.reuse, R5, R60 ;
/*2270*/ FFMA R63, R16.reuse, R6, R63 ;
/*2280*/ FFMA R26, R16, R7, R62 ;
/*2290*/ IMAD.WIDE.U32 R16, R24, R25, RZ ;
/*22a0*/ FFMA R97, R18.reuse, R4, R97 ;
/*22b0*/ FFMA R96, R18.reuse, R5.reuse, R96 ;
/*22c0*/ FFMA R99, R18, R6, R99 ;
/*22d0*/ FFMA R101, R20.reuse, R4, R101 ;
/*22e0*/ FFMA R100, R20.reuse, R5, R100 ;
/*22f0*/ FFMA R103, R20, R6, R103 ;
/*2300*/ FFMA R18, R18, R7, R98 ;
/*2310*/ FFMA R95, R22.reuse, R4, R95 ;
/*2320*/ FFMA R104, R22.reuse, R5, R104 ;
/*2330*/ FFMA R105, R22, R6, R105 ;
/*2340*/ FFMA R20, R20, R7.reuse, R102 ;
/*2350*/ FFMA R22, R22, R7, R106 ;
/*2360*/ IADD3 R13, R17, R13, RZ ;
/*2370*/ @P0 BRA 0x24b0 ;
/*2380*/ IADD3 R4, R10.reuse, 0x1, RZ ;
/*2390*/ IADD3 R6, R10.reuse, 0x2, RZ ;
/*23a0*/ IADD3 R17, P1, R10, R16, RZ ;
/*23b0*/ ISETP.GE.AND P3, PT, R4, R25.reuse, PT ;
/*23c0*/ ISETP.GE.AND P2, PT, R10, R25.reuse, PT ;
/*23d0*/ ISETP.GE.AND P4, PT, R6, R25, PT ;
/*23e0*/ CS2R R6, SRZ ;
/*23f0*/ IADD3.X R4, R11, R13, RZ, P1, !PT ;
/*2400*/ LEA R16, P1, R17, R8, 0x2 ;
/*2410*/ LEA.HI.X R17, R17, R9, R4, 0x2, P1 ;
/*2420*/ CS2R R4, SRZ ;
/*2430*/ @!P4 LDG.E R6, desc[UR12][R16.64+0x8] ;
/*2440*/ @!P2 LDG.E R4, desc[UR12][R16.64] ;
/*2450*/ @!P3 LDG.E R5, desc[UR12][R16.64+0x4] ;
/*2460*/ IADD3 R24, R10, 0x3, RZ ;
/*2470*/ ISETP.GE.AND P1, PT, R24, R25, PT ;
/*2480*/ @P1 BRA 0x2500 ;
/*2490*/ LDG.E R7, desc[UR12][R16.64+0xc] ;
/*24a0*/ BRA 0x2500 ;
/*24b0*/ IADD3 R16, P1, R10, R16, RZ ;
/*24c0*/ IMAD.X R13, R11, 0x1, R13, P1 ;
/*24d0*/ LEA R4, P1, R16, R8, 0x2 ;
/*24e0*/ LEA.HI.X R5, R16, R9, R13, 0x2, P1 ;
/*24f0*/ LDG.E.128.CONSTANT R4, desc[UR12][R4.64] ;
/*2500*/ BSYNC B3 ;
/*2510*/ LDS R62, [R15+0x4] ;
/*2520*/ IADD3 R14, R14, 0x2, RZ ;
/*2530*/ LDS R98, [R19+0x4] ;
/*2540*/ ISETP.GE.AND P1, PT, R14, R12, PT ;
/*2550*/ LDS R102, [R21+0x4] ;
/*2560*/ LDS R106, [R23+0x4] ;
/*2570*/ FFMA R61, R62.reuse, R4, R61 ;
/*2580*/ FFMA R60, R62.reuse, R5, R60 ;
/*2590*/ FFMA R63, R62.reuse, R6, R63 ;
/*25a0*/ FFMA R62, R62, R7, R26 ;
/*25b0*/ FFMA R97, R98.reuse, R4, R97 ;
/*25c0*/ FFMA R96, R98.reuse, R5, R96 ;
/*25d0*/ FFMA R99, R98.reuse, R6, R99 ;
/*25e0*/ FFMA R98, R98, R7, R18 ;
/*25f0*/ FFMA R101, R102.reuse, R4, R101 ;
/*2600*/ FFMA R100, R102.reuse, R5, R100 ;
/*2610*/ FFMA R103, R102.reuse, R6, R103 ;
/*2620*/ FFMA R102, R102, R7, R20 ;
/*2630*/ FFMA R95, R106.reuse, R4, R95 ;
/*2640*/ FFMA R104, R106.reuse, R5, R104 ;
/*2650*/ FFMA R105, R106.reuse, R6, R105 ;
/*2660*/ FFMA R106, R106, R7, R22 ;
/*2670*/ @!P1 BRA 0x1f80 ;
/*2680*/ BSYNC B2 ;
/*2690*/ BRA 0x3aa0 ;
/*26a0*/ IMAD.WIDE R14, R14, R49, R10 ;
/*26b0*/ LEA R68, P0, R14, R8, 0x2 ;
/*26c0*/ LEA.HI.X R69, R14, R9, R15, 0x2, P0 ;
/*26d0*/ IMAD.WIDE R72, R49, 0x4, R68 ;
/*26e0*/ LDG.E.NA.LTC256B.128.CONSTANT R68, desc[UR12][R68.64] ;
/*26f0*/ IMAD.WIDE R52, R49, 0x4, R72 ;
/*2700*/ LDG.E.NA.LTC256B.128.CONSTANT R72, desc[UR12][R72.64] ;
/*2710*/ IMAD.WIDE R56, R49, 0x4, R52 ;
/*2720*/ LDG.E.NA.LTC256B.128.CONSTANT R52, desc[UR12][R52.64] ;
/*2730*/ IMAD.WIDE R4, R49, 0x4, R56 ;
/*2740*/ LDG.E.NA.LTC256B.128.CONSTANT R56, desc[UR12][R56.64] ;
/*2750*/ IMAD.WIDE R8, R49, 0x4, R4 ;
/*2760*/ LDG.E.NA.LTC256B.128.CONSTANT R4, desc[UR12][R4.64] ;
/*2770*/ IMAD.WIDE R12, R49, 0x4, R8 ;
/*2780*/ LDG.E.NA.LTC256B.128.CONSTANT R8, desc[UR12][R8.64] ;
/*2790*/ IMAD.WIDE R16, R49, 0x4, R12 ;
/*27a0*/ LDG.E.NA.LTC256B.128.CONSTANT R12, desc[UR12][R12.64] ;
/*27b0*/ IMAD.WIDE R20, R49, 0x4, R16 ;
/*27c0*/ LDG.E.NA.LTC256B.128.CONSTANT R16, desc[UR12][R16.64] ;
/*27d0*/ IMAD.WIDE R24, R49, 0x4, R20 ;
/*27e0*/ LDG.E.NA.LTC256B.128.CONSTANT R20, desc[UR12][R20.64] ;
/*27f0*/ IMAD.WIDE R28, R49, 0x4, R24 ;
/*2800*/ LDG.E.NA.LTC256B.128.CONSTANT R24, desc[UR12][R24.64] ;
/*2810*/ IMAD.WIDE R32, R49, 0x4, R28 ;
/*2820*/ LDG.E.NA.LTC256B.128.CONSTANT R28, desc[UR12][R28.64] ;
/*2830*/ IMAD.WIDE R36, R49, 0x4, R32 ;
/*2840*/ LDG.E.NA.LTC256B.128.CONSTANT R32, desc[UR12][R32.64] ;
/*2850*/ IMAD.WIDE R40, R49, 0x4, R36 ;
/*2860*/ LDG.E.NA.LTC256B.128.CONSTANT R36, desc[UR12][R36.64] ;
/*2870*/ IMAD.WIDE R44, R49, 0x4, R40 ;
/*2880*/ LDG.E.NA.LTC256B.128.CONSTANT R40, desc[UR12][R40.64] ;
/*2890*/ IMAD.WIDE R48, R49, 0x4, R44 ;
/*28a0*/ LDG.E.NA.LTC256B.128.CONSTANT R44, desc[UR12][R44.64] ;
/*28b0*/ LDG.E.NA.LTC256B.128.CONSTANT R48, desc[UR12][R48.64] ;
/*28c0*/ LOP3.LUT P0, RZ, R85, 0xff, RZ, 0xc0, !PT ;
/*28d0*/ BSSY B2, 0x2950 ;
/*28e0*/ @P0 BRA 0x2940 ;
/*28f0*/ LEA R64, R64, R67, 0x18 ;
/*2900*/ YIELD ;
/*2910*/ SYNCS.PHASECHK.TRANS64.TRYWAIT P0, [R64+URZ], RZ ;
/*2920*/ @!P0 BRA 0x2900 ;
/*2930*/ HFMA2.MMA R85, -RZ, RZ, 0, 5.9604644775390625e-08 ;
/*2940*/ BSYNC B2 ;
/*2950*/ LEA R94, R86, R65, 0x6 ;
/*2960*/ LDS.128 R80, [R93] ;
/*2970*/ LEA R76, R76, 0x3c, 0x2 ;
/*2980*/ LDS.128 R64, [R94] ;
/*2990*/ LOP3.LUT R90, R76, 0xffffffc0, RZ, 0xc0, !PT ;
/*29a0*/ IADD3 R92, R93, R90, RZ ;
/*29b0*/ IADD3 R90, R92, R90, RZ ;
/*29c0*/ LDS.128 R76, [R92] ;
/*29d0*/ FFMA R97, R68, R80.reuse, R97 ;
/*29e0*/ FFMA R96, R69, R80.reuse, R96 ;
/*29f0*/ FFMA R99, R70, R80.reuse, R99 ;
/*2a00*/ FFMA R80, R71, R80, R98 ;
/*2a10*/ FFMA R61, R68, R64.reuse, R61 ;
/*2a20*/ FFMA R60, R69, R64.reuse, R60 ;
/*2a30*/ FFMA R63, R70, R64.reuse, R63 ;
/*2a40*/ FFMA R62, R71, R64, R62 ;
/*2a50*/ FFMA R61, R72, R65.reuse, R61 ;
/*2a60*/ FFMA R60, R73, R65.reuse, R60 ;
/*2a70*/ FFMA R63, R74, R65.reuse, R63 ;
/*2a80*/ FFMA R64, R75, R65, R62 ;
/*2a90*/ FFMA R107, R52, R66.reuse, R61 ;
/*2aa0*/ FFMA R108, R53, R66.reuse, R60 ;
/*2ab0*/ FFMA R109, R54, R66, R63 ;
/*2ac0*/ FFMA R101, R68, R76.reuse, R101 ;
/*2ad0*/ LDS.128 R60, [R90] ;
/*2ae0*/ FFMA R80, R75, R81.reuse, R80 ;
/*2af0*/ FFMA R100, R69, R76.reuse, R100 ;
/*2b00*/ FFMA R103, R70, R76.reuse, R103 ;
/*2b10*/ FFMA R97, R72, R81.reuse, R97 ;
/*2b20*/ FFMA R96, R73, R81.reuse, R96 ;
/*2b30*/ FFMA R99, R74, R81, R99 ;
/*2b40*/ FFMA R76, R71, R76, R102 ;
/*2b50*/ FFMA R101, R72, R77.reuse, R101 ;
/*2b60*/ FFMA R64, R55.reuse, R66, R64 ;
/*2b70*/ FFMA R80, R55, R82.reuse, R80 ;
/*2b80*/ FFMA R100, R73, R77.reuse, R100 ;
/*2b90*/ FFMA R103, R74, R77.reuse, R103 ;
/*2ba0*/ FFMA R97, R52, R82.reuse, R97 ;
/*2bb0*/ FFMA R96, R53, R82.reuse, R96 ;
/*2bc0*/ FFMA R99, R54, R82, R99 ;
/*2bd0*/ FFMA R76, R75, R77, R76 ;
/*2be0*/ FFMA R77, R52, R78.reuse, R101 ;
/*2bf0*/ FFMA R100, R53, R78.reuse, R100 ;
/*2c00*/ FFMA R101, R54, R78.reuse, R103 ;
/*2c10*/ FFMA R107, R56, R67.reuse, R107 ;
/*2c20*/ FFMA R108, R57, R67.reuse, R108 ;
/*2c30*/ FFMA R109, R58, R67.reuse, R109 ;
/*2c40*/ FFMA R110, R59, R67, R64 ;
/*2c50*/ FFMA R97, R56, R83.reuse, R97 ;
/*2c60*/ FFMA R96, R57, R83.reuse, R96 ;
/*2c70*/ FFMA R99, R58, R83.reuse, R99 ;
/*2c80*/ FFMA R98, R59, R83, R80 ;
/*2c90*/ FFMA R78, R55, R78, R76 ;
/*2ca0*/ LDS.128 R64, [R94+0x10] ;
/*2cb0*/ FFMA R77, R56, R79.reuse, R77 ;
/*2cc0*/ FFMA R76, R57, R79.reuse, R100 ;
/*2cd0*/ FFMA R101, R58, R79.reuse, R101 ;
/*2ce0*/ LDS.128 R80, [R93+0x10] ;
/*2cf0*/ FFMA R78, R59, R79, R78 ;
/*2d00*/ FFMA R95, R68, R60.reuse, R95 ;
/*2d10*/ FFMA R104, R69, R60.reuse, R104 ;
/*2d20*/ FFMA R105, R70, R60.reuse, R105 ;
/*2d30*/ FFMA R60, R71, R60, R106 ;
/*2d40*/ FFMA R95, R72, R61.reuse, R95 ;
/*2d50*/ FFMA R104, R73, R61.reuse, R104 ;
/*2d60*/ FFMA R105, R74, R61.reuse, R105 ;
/*2d70*/ FFMA R60, R75, R61, R60 ;
/*2d80*/ FFMA R73, R52, R62.reuse, R95 ;
/*2d90*/ FFMA R72, R53, R62.reuse, R104 ;
/*2da0*/ FFMA R75, R54, R62.reuse, R105 ;
/*2db0*/ FFMA R60, R55, R62, R60 ;
/*2dc0*/ LDS.128 R68, [R92+0x10] ;
/*2dd0*/ FFMA R73, R56, R63.reuse, R73 ;
/*2de0*/ FFMA R72, R57, R63.reuse, R72 ;
/*2df0*/ FFMA R75, R58, R63.reuse, R75 ;
/*2e00*/ LDS.128 R52, [R90+0x10] ;
/*2e10*/ FFMA R74, R59, R63, R60 ;
/*2e20*/ LDS.128 R56, [R94+0x20] ;
/*2e30*/ LDS.128 R60, [R93+0x20] ;
/*2e40*/ FFMA R107, R4, R64.reuse, R107 ;
/*2e50*/ FFMA R108, R5, R64.reuse, R108 ;
/*2e60*/ FFMA R109, R6, R64.reuse, R109 ;
/*2e70*/ FFMA R110, R7, R64, R110 ;
/*2e80*/ FFMA R97, R4, R80.reuse, R97 ;
/*2e90*/ FFMA R96, R5, R80.reuse, R96 ;
/*2ea0*/ FFMA R99, R6, R80.reuse, R99 ;
/*2eb0*/ FFMA R98, R7, R80, R98 ;
/*2ec0*/ FFMA R107, R8, R65.reuse, R107 ;
/*2ed0*/ FFMA R108, R9, R65.reuse, R108 ;
/*2ee0*/ FFMA R109, R10, R65.reuse, R109 ;
/*2ef0*/ FFMA R110, R11, R65, R110 ;
/*2f00*/ FFMA R65, R12, R66.reuse, R107 ;
/*2f10*/ FFMA R64, R13, R66.reuse, R108 ;
/*2f20*/ FFMA R79, R14, R66.reuse, R109 ;
/*2f30*/ FFMA R66, R15, R66, R110 ;
/*2f40*/ FFMA R97, R8, R81.reuse, R97 ;
/*2f50*/ FFMA R96, R9, R81.reuse, R96 ;
/*2f60*/ FFMA R99, R10, R81, R99 ;
/*2f70*/ FFMA R65, R16, R67.reuse, R65 ;
/*2f80*/ FFMA R64, R17, R67.reuse, R64 ;
/*2f90*/ FFMA R79, R18, R67, R79 ;
/*2fa0*/ FFMA R98, R11, R81, R98 ;
/*2fb0*/ FFMA R77, R4, R68.reuse, R77 ;
/*2fc0*/ FFMA R76, R5, R68.reuse, R76 ;
/*2fd0*/ FFMA R101, R6, R68.reuse, R101 ;
/*2fe0*/ FFMA R78, R7, R68, R78 ;
/*2ff0*/ FFMA R73, R4, R52.reuse, R73 ;
/*3000*/ FFMA R72, R5, R52.reuse, R72 ;
/*3010*/ FFMA R75, R6, R52.reuse, R75 ;
/*3020*/ FFMA R74, R7, R52, R74 ;
/*3030*/ FFMA R77, R8, R69.reuse, R77 ;
/*3040*/ LDS.128 R4, [R92+0x20] ;
/*3050*/ FFMA R76, R9, R69.reuse, R76 ;
/*3060*/ FFMA R101, R10, R69.reuse, R101 ;
/*3070*/ FFMA R78, R11, R69, R78 ;
/*3080*/ FFMA R69, R12, R70.reuse, R77 ;
/*3090*/ FFMA R68, R13, R70.reuse, R76 ;
/*30a0*/ FFMA R77, R14, R70.reuse, R101 ;
/*30b0*/ FFMA R70, R15, R70, R78 ;
/*30c0*/ FFMA R73, R8, R53.reuse, R73 ;
/*30d0*/ FFMA R72, R9, R53.reuse, R72 ;
/*30e0*/ FFMA R75, R10, R53.reuse, R75 ;
/*30f0*/ FFMA R74, R11, R53, R74 ;
/*3100*/ FFMA R66, R19, R67, R66 ;
/*3110*/ FFMA R67, R12, R82.reuse, R97 ;
/*3120*/ FFMA R69, R16, R71.reuse, R69 ;
/*3130*/ FFMA R68, R17, R71.reuse, R68 ;
/*3140*/ FFMA R77, R18, R71.reuse, R77 ;
/*3150*/ FFMA R70, R19, R71, R70 ;
/*3160*/ FFMA R80, R13.reuse, R82.reuse, R96 ;
/*3170*/ FFMA R81, R14, R82, R99 ;
/*3180*/ FFMA R53, R12, R54.reuse, R73 ;
/*3190*/ FFMA R52, R13, R54.reuse, R72 ;
/*31a0*/ FFMA R71, R14, R54, R75 ;
/*31b0*/ FFMA R82, R15.reuse, R82, R98 ;
/*31c0*/ FFMA R54, R15, R54, R74 ;
/*31d0*/ FFMA R65, R20, R56.reuse, R65 ;
/*31e0*/ FFMA R64, R21, R56.reuse, R64 ;
/*31f0*/ FFMA R79, R22, R56.reuse, R79 ;
/*3200*/ FFMA R66, R23, R56, R66 ;
/*3210*/ FFMA R67, R16, R83.reuse, R67 ;
/*3220*/ FFMA R80, R17, R83.reuse, R80 ;
/*3230*/ FFMA R81, R18, R83.reuse, R81 ;
/*3240*/ FFMA R82, R19, R83, R82 ;
/*3250*/ FFMA R53, R16, R55.reuse, R53 ;
/*3260*/ FFMA R52, R17, R55.reuse, R52 ;
/*3270*/ FFMA R71, R18, R55.reuse, R71 ;
/*3280*/ FFMA R54, R19, R55, R54 ;
/*3290*/ FFMA R65, R24, R57.reuse, R65 ;
/*32a0*/ FFMA R64, R25, R57.reuse, R64 ;
/*32b0*/ FFMA R79, R26, R57.reuse, R79 ;
/*32c0*/ FFMA R66, R27, R57, R66 ;
/*32d0*/ LDS.128 R16, [R90+0x20] ;
/*32e0*/ FFMA R67, R20.reuse, R60, R67 ;
/*32f0*/ FFMA R69, R20, R4, R69 ;
/*3300*/ FFMA R55, R28, R58.reuse, R65 ;
/*3310*/ FFMA R56, R29, R58.reuse, R64 ;
/*3320*/ FFMA R57, R30, R58, R79 ;
/*3330*/ FFMA R68, R21, R4.reuse, R68 ;
/*3340*/ FFMA R77, R22, R4.reuse, R77 ;
/*3350*/ FFMA R70, R23, R4, R70 ;
/*3360*/ FFMA R58, R31, R58, R66 ;
/*3370*/ FFMA R67, R24.reuse, R61, R67 ;
/*3380*/ FFMA R69, R24, R5.reuse, R69 ;
/*3390*/ FFMA R68, R25, R5.reuse, R68 ;
/*33a0*/ FFMA R77, R26, R5.reuse, R77 ;
/*33b0*/ FFMA R70, R27, R5, R70 ;
/*33c0*/ FFMA R55, R32, R59.reuse, R55 ;
/*33d0*/ FFMA R56, R33, R59.reuse, R56 ;
/*33e0*/ FFMA R57, R34, R59.reuse, R57 ;
/*33f0*/ FFMA R58, R35, R59, R58 ;
/*3400*/ FFMA R59, R28.reuse, R62, R67 ;
/*3410*/ FFMA R67, R28, R6.reuse, R69 ;
/*3420*/ FFMA R68, R29, R6.reuse, R68 ;
/*3430*/ FFMA R69, R30, R6.reuse, R77 ;
/*3440*/ FFMA R70, R31, R6, R70 ;
/*3450*/ LDS.128 R12, [R94+0x30] ;
/*3460*/ FFMA R67, R32, R7.reuse, R67 ;
/*3470*/ FFMA R68, R33, R7.reuse, R68 ;
/*3480*/ FFMA R69, R34, R7.reuse, R69 ;
/*3490*/ LDS.128 R8, [R93+0x30] ;
/*34a0*/ FFMA R70, R35, R7, R70 ;
/*34b0*/ FFMA R80, R21, R60.reuse, R80 ;
/*34c0*/ FFMA R81, R22, R60.reuse, R81 ;
/*34d0*/ LDS.128 R92, [R92+0x30] ;
/*34e0*/ FFMA R82, R23, R60, R82 ;
/*34f0*/ FFMA R80, R25, R61.reuse, R80 ;
/*3500*/ FFMA R81, R26, R61.reuse, R81 ;
/*3510*/ LDS.128 R4, [R90+0x30] ;
/*3520*/ FFMA R82, R27, R61, R82 ;
/*3530*/ FFMA R64, R29, R62.reuse, R80 ;
/*3540*/ FFMA R65, R30, R62, R81 ;
/*3550*/ FFMA R53, R20, R16.reuse, R53 ;
/*3560*/ FFMA R52, R21, R16.reuse, R52 ;
/*3570*/ FFMA R71, R22, R16.reuse, R71 ;
/*3580*/ FFMA R54, R23, R16, R54 ;
/*3590*/ FFMA R53, R24, R17.reuse, R53 ;
/*35a0*/ FFMA R52, R25, R17.reuse, R52 ;
/*35b0*/ FFMA R71, R26, R17.reuse, R71 ;
/*35c0*/ FFMA R54, R27, R17, R54 ;
/*35d0*/ FFMA R66, R31, R62, R82 ;
/*35e0*/ FFMA R53, R28, R18.reuse, R53 ;
/*35f0*/ FFMA R52, R29, R18.reuse, R52 ;
/*3600*/ FFMA R71, R30, R18.reuse, R71 ;
/*3610*/ FFMA R54, R31, R18, R54 ;
/*3620*/ FFMA R59, R32, R63.reuse, R59 ;
/*3630*/ FFMA R64, R33, R63.reuse, R64 ;
/*3640*/ FFMA R65, R34, R63.reuse, R65 ;
/*3650*/ FFMA R66, R35, R63, R66 ;
/*3660*/ FFMA R53, R32, R19.reuse, R53 ;
/*3670*/ FFMA R52, R33, R19.reuse, R52 ;
/*3680*/ FFMA R71, R34, R19.reuse, R71 ;
/*3690*/ FFMA R54, R35, R19, R54 ;
/*36a0*/ FFMA R55, R36, R12.reuse, R55 ;
/*36b0*/ FFMA R56, R37, R12.reuse, R56 ;
/*36c0*/ FFMA R57, R38, R12.reuse, R57 ;
/*36d0*/ FFMA R58, R39, R12, R58 ;
/*36e0*/ FFMA R59, R36, R8.reuse, R59 ;
/*36f0*/ FFMA R64, R37, R8.reuse, R64 ;
/*3700*/ FFMA R65, R38, R8.reuse, R65 ;
/*3710*/ FFMA R66, R39, R8, R66 ;
/*3720*/ FFMA R67, R36, R92.reuse, R67 ;
/*3730*/ FFMA R68, R37, R92.reuse, R68 ;
/*3740*/ FFMA R69, R38, R92.reuse, R69 ;
/*3750*/ FFMA R70, R39, R92, R70 ;
/*3760*/ FFMA R53, R36, R4.reuse, R53 ;
/*3770*/ FFMA R52, R37, R4.reuse, R52 ;
/*3780*/ FFMA R71, R38, R4.reuse, R71 ;
/*3790*/ FFMA R54, R39, R4, R54 ;
/*37a0*/ FFMA R67, R40, R93.reuse, R67 ;
/*37b0*/ FFMA R68, R41, R93.reuse, R68 ;
/*37c0*/ FFMA R69, R42, R93.reuse, R69 ;
/*37d0*/ FFMA R70, R43, R93, R70 ;
/*37e0*/ FFMA R55, R40, R13.reuse, R55 ;
/*37f0*/ FFMA R56, R41, R13.reuse, R56 ;
/*3800*/ FFMA R57, R42, R13.reuse, R57 ;
/*3810*/ FFMA R58, R43, R13, R58 ;
/*3820*/ FFMA R59, R40, R9.reuse, R59 ;
/*3830*/ FFMA R64, R41, R9.reuse, R64 ;
/*3840*/ FFMA R65, R42, R9.reuse, R65 ;
/*3850*/ FFMA R66, R43, R9, R66 ;
/*3860*/ FFMA R53, R40, R5.reuse, R53 ;
/*3870*/ FFMA R52, R41, R5.reuse, R52 ;
/*3880*/ FFMA R71, R42, R5.reuse, R71 ;
/*3890*/ FFMA R54, R43, R5, R54 ;
/*38a0*/ FFMA R67, R44, R94.reuse, R67 ;
/*38b0*/ FFMA R68, R45, R94.reuse, R68 ;
/*38c0*/ FFMA R69, R46, R94.reuse, R69 ;
/*38d0*/ FFMA R70, R47, R94, R70 ;
/*38e0*/ FFMA R55, R44, R14.reuse, R55 ;
/*38f0*/ FFMA R56, R45, R14.reuse, R56 ;
/*3900*/ FFMA R57, R46, R14.reuse, R57 ;
/*3910*/ FFMA R58, R47, R14, R58 ;
/*3920*/ FFMA R59, R44, R10.reuse, R59 ;
/*3930*/ FFMA R64, R45, R10.reuse, R64 ;
/*3940*/ FFMA R65, R46, R10.reuse, R65 ;
/*3950*/ FFMA R66, R47, R10, R66 ;
/*3960*/ FFMA R53, R44, R6.reuse, R53 ;
/*3970*/ FFMA R52, R45, R6.reuse, R52 ;
/*3980*/ FFMA R71, R46, R6.reuse, R71 ;
/*3990*/ FFMA R54, R47, R6, R54 ;
/*39a0*/ FFMA R101, R48, R95.reuse, R67 ;
/*39b0*/ FFMA R100, R49, R95.reuse, R68 ;
/*39c0*/ FFMA R103, R50, R95.reuse, R69 ;
/*39d0*/ FFMA R102, R51, R95, R70 ;
/*39e0*/ FFMA R61, R48, R15.reuse, R55 ;
/*39f0*/ FFMA R60, R49, R15.reuse, R56 ;
/*3a00*/ FFMA R63, R50, R15.reuse, R57 ;
/*3a10*/ FFMA R62, R51, R15, R58 ;
/*3a20*/ FFMA R97, R48, R11.reuse, R59 ;
/*3a30*/ FFMA R96, R49, R11.reuse, R64 ;
/*3a40*/ FFMA R99, R50, R11.reuse, R65 ;
/*3a50*/ FFMA R98, R51, R11, R66 ;
/*3a60*/ FFMA R95, R48, R7.reuse, R53 ;
/*3a70*/ FFMA R104, R49, R7.reuse, R52 ;
/*3a80*/ FFMA R105, R50, R7.reuse, R71 ;
/*3a90*/ FFMA R106, R51, R7, R54 ;
/*3aa0*/ BSYNC B1 ;
/*3ab0*/ VIADD R86, R86, 0x8 ;
/*3ac0*/ IADD3 R88, P1, R88, 0x1, RZ ;
/*3ad0*/ IADD3 R87, R87, 0x1, RZ ;
/*3ae0*/ ISETP.GE.AND P0, PT, R86, UR4, PT ;
/*3af0*/ IADD3.X R89, RZ, R89, RZ, P1, !PT ;
/*3b00*/ @!P0 BRA 0x17a0 ;
"""

WGMMA_BF16 = """\
/*0000*/ LDC R1, c[0x0][0x28] ; /* 0x00000a00ff017b82 */
   /* 0x000e300000000800 */
/*0010*/ LDC R7, c[0x0][0x14] ; /* 0x00000500ff077b82 */
   /* 0x000e620000000800 */
/*0020*/ BSSY B0, 0x3a0 ; /* 0x0000037000007945 */
   /* 0x000fee0003800000 */
/*0030*/ LDC R0, c[0x0][0x350] ; /* 0x0000d400ff007b82 */
   /* 0x000eb00000000800 */
/*0040*/ S2UR UR4, SR_CTAID.X ; /* 0x00000000000479c3 */
   /* 0x000ee20000002500 */
/*0050*/ I2F.U32.RP R4, R7 ; /* 0x0000000700047306 */
   /* 0x002e6e0000209000 */
/*0060*/ S2UR UR7, SR_CTAID.Y ; /* 0x00000000000779c3 */
   /* 0x000f220000002600 */
/*0070*/ ISETP.NE.U32.AND P2, PT, R7, RZ, PT ; /* 0x000000ff0700720c */
   /* 0x000fe20003f45070 */
/*0080*/ VIADD R0, R0, 0x3f ; /* 0x0000003f00007836 */
   /* 0x004fca0000000000 */
/*0090*/ SHF.R.S32.HI R5, RZ, 0x1f, R0 ; /* 0x0000001fff057819 */
   /* 0x000fe20000011400 */
/*00a0*/ MUFU.RCP R4, R4 ; /* 0x0000000400047308 */
   /* 0x002e620000001000 */
/*00b0*/ USHF.L.U32 UR14, UR4, 0x7, URZ ; /* 0x00000007040e7899 */
   /* 0x008fe4000800063f */
/*00c0*/ LEA.HI R5, R5, R0, RZ, 0x6 ;
/*00d0*/ SHF.R.S32.HI R5, RZ, 0x6, R5 ;
/*00e0*/ IADD3 R0, R7, -0x1, R5 ;
/*00f0*/ USHF.L.U32 UR7, UR7, 0x7, URZ ;
/*0100*/ VIADD R2, R4, 0xffffffe ;
/*0110*/ S2R R4, SR_TID.X ;
/*0120*/ F2I.FTZ.U32.TRUNC.NTZ R3, R2 ;
/*0130*/ IMAD.MOV.U32 R2, RZ, RZ, RZ ;
/*0140*/ IMAD.MOV R6, RZ, RZ, -R3 ;
/*0150*/ IMAD R9, R6, R7, RZ ;
/*0160*/ IMAD.HI.U32 R3, R3, R9, R2 ;
/*0170*/ IMAD.HI.U32 R2, R3, R0, RZ ;
/*0180*/ ISETP.NE.AND P3, PT, R4, RZ, PT ;
/*0190*/ IMAD.MOV R3, RZ, RZ, -R2 ;
/*01a0*/ IMAD R0, R7, R3, R0 ;
/*01b0*/ S2R R3, SR_CTAID.Z ;
/*01c0*/ ISETP.GE.U32.AND P0, PT, R0, R7, PT ;
/*01d0*/ @P0 IMAD.IADD R0, R0, 0x1, -R7 ;
/*01e0*/ @P0 VIADD R2, R2, 0x1 ;
/*01f0*/ ISETP.GE.U32.AND P1, PT, R0, R7, PT ;
/*0200*/ @P1 VIADD R2, R2, 0x1 ;
/*0210*/ @P3 BRA 0x390 ;
/*0220*/ S2UR UR5, SR_CgaCtaId ;
/*0230*/ UMOV UR4, 0x400 ;
/*0240*/ UMOV UR8, 0x100 ;
/*0250*/ UIADD3 UR8, -UR8, 0x100000, URZ ;
/*0260*/ USHF.L.U32 UR9, UR8, 0xb, URZ ;
/*0270*/ USHF.L.U32 UR8, UR8, 0x1, URZ ;
/*0280*/ ULEA UR4, UR5, UR4, 0x18 ;
/*0290*/ UIADD3 UR6, UR4, 0x3ff, URZ ;
/*02a0*/ UMOV UR4, 0x1 ;
/*02b0*/ ULOP3.LUT UR6, UR6, 0xfffffc00, URZ, 0xc0, !UPT ;
/*02c0*/ UIADD3 UR4, -UR4, 0x100000, URZ ;
/*02d0*/ USHF.L.U32 UR5, UR4, 0xb, URZ ;
/*02e0*/ USHF.L.U32 UR4, UR4, 0x1, URZ ;
/*02f0*/ FENCE.VIEW.ASYNC.S ;
/*0300*/ SYNCS.EXCH.64 URZ, [UR6+0x20000], UR4 ;
/*0310*/ SYNCS.EXCH.64 URZ, [UR6+0x20020], UR8 ;
/*0320*/ SYNCS.EXCH.64 URZ, [UR6+0x20008], UR4 ;
/*0330*/ SYNCS.EXCH.64 URZ, [UR6+0x20028], UR8 ;
/*0340*/ SYNCS.EXCH.64 URZ, [UR6+0x20010], UR4 ;
/*0350*/ SYNCS.EXCH.64 URZ, [UR6+0x20030], UR8 ;
/*0360*/ SYNCS.EXCH.64 URZ, [UR6+0x20018], UR4 ;
/*0370*/ SYNCS.EXCH.64 URZ, [UR6+0x20038], UR8 ;
/*0380*/ NOP ;
/*0390*/ BSYNC B0 ;
/*03a0*/ @!P2 LOP3.LUT R2, RZ, R7, RZ, 0x33, !PT ;
/*03b0*/ BAR.SYNC.DEFER_BLOCKING 0x0 ;
/*03c0*/ IMAD R0, R2, R3, RZ ;
/*03d0*/ SHF.R.U32.HI R3, RZ, 0x7, R4 ;
/*03e0*/ ULDC UR16, c[0x0][0x348] ;
/*03f0*/ ISETP.NE.AND P0, PT, R3, RZ, PT ;
/*0400*/ VIADDMNMX R5, R0, R2, R5, PT ;
/*0410*/ IMAD.IADD R5, R5, 0x1, -R0 ;
/*0420*/ VIMNMX R2, RZ, R5, !PT ;
/*0430*/ @!P0 BRA 0x2b60 ;
/*0440*/ ISETP.GE.AND P0, PT, R5, 0x1, PT ;
/*0450*/ VIADD R5, R3, 0xffffffff ;
/*0460*/ CS2R R86, SRZ ;
/*0470*/ CS2R R24, SRZ ;
/*0480*/ CS2R R26, SRZ ;
/*0490*/ CS2R R28, SRZ ;
/*04a0*/ CS2R R30, SRZ ;
/*04b0*/ CS2R R32, SRZ ;
/*04c0*/ CS2R R34, SRZ ;
/*04d0*/ CS2R R36, SRZ ;
/*04e0*/ CS2R R38, SRZ ;
/*04f0*/ CS2R R40, SRZ ;
/*0500*/ CS2R R42, SRZ ;
/*0510*/ CS2R R44, SRZ ;
/*0520*/ CS2R R46, SRZ ;
/*0530*/ CS2R R48, SRZ ;
/*0540*/ CS2R R50, SRZ ;
/*0550*/ CS2R R52, SRZ ;
/*0560*/ CS2R R54, SRZ ;
/*0570*/ CS2R R56, SRZ ;
/*0580*/ CS2R R58, SRZ ;
/*0590*/ CS2R R60, SRZ ;
/*05a0*/ CS2R R62, SRZ ;
/*05b0*/ CS2R R64, SRZ ;
/*05c0*/ CS2R R66, SRZ ;
/*05d0*/ CS2R R68, SRZ ;
/*05e0*/ CS2R R70, SRZ ;
/*05f0*/ CS2R R72, SRZ ;
/*0600*/ CS2R R74, SRZ ;
/*0610*/ CS2R R76, SRZ ;
/*0620*/ CS2R R78, SRZ ;
/*0630*/ CS2R R80, SRZ ;
/*0640*/ CS2R R82, SRZ ;
/*0650*/ CS2R R84, SRZ ;
/*0660*/ LEA R0, R5, UR7, 0x6 ;
/*0670*/ @!P0 BRA 0xc20 ;
/*0680*/ S2R R4, SR_CgaCtaId ;
/*0690*/ MOV R3, 0x400 ;
/*06a0*/ BSSY B0, 0xc20 ;
/*06b0*/ LEA R3, R4, R3, 0x18 ;
/*06c0*/ VIADD R3, R3, 0x3ff ;
/*06d0*/ LOP3.LUT R4, R3, 0xfffffc00, RZ, 0xc0, !PT ;
/*06e0*/ IMAD.MOV.U32 R3, RZ, RZ, RZ ;
/*06f0*/ IMAD R5, R5, 0x2000, R4 ;
/*0700*/ SHF.R.U32.HI R6, RZ, 0x2, R3 ;
/*0710*/ IMAD.SHL.U32 R7, R3, 0x8, RZ ;
/*0720*/ BSSY B1, 0x7a0 ;
/*0730*/ ISETP.GE.AND P1, PT, R0, UR16, PT ;
/*0740*/ LOP3.LUT R8, R6, 0x1, RZ, 0xc0, !PT ;
/*0750*/ LOP3.LUT R6, R4, 0x18, R7, 0xf8, !PT ;
/*0760*/ IMAD.U32 R7, R8, -0x80000000, RZ ;
/*0770*/ SYNCS.PHASECHK.TRANS64.TRYWAIT P0, [R6+URZ+0x20000], R7 ;
/*0780*/ @!P0 BRA 0x3040 ;
/*0790*/ BSYNC B1 ;
/*07a0*/ LOP3.LUT R7, R3, 0x3, RZ, 0xc0, !PT ;
/*07b0*/ @P1 BRA 0xbd0 ;
/*07c0*/ IMAD R8, R7.reuse, 0x8000, R4 ;
/*07d0*/ WARPSYNC.ALL ;
/*07e0*/ NOP ;
/*07f0*/ IMAD R7, R7, 0x8000, R5 ;
/*0800*/ WARPGROUP.ARRIVE ;
/*0810*/ VIADD R9, R8, 0x4000 ;
/*0820*/ IMAD.MOV.U32 R11, RZ, RZ, 0x40000040 ;
/*0830*/ LOP3.LUT R10, R7, 0x3fc00, RZ, 0xc0, !PT ;
/*0840*/ IMAD.MOV.U32 R13, RZ, RZ, 0x40000040 ;
/*0850*/ LOP3.LUT R9, R9, 0x3fc00, RZ, 0xc0, !PT ;
/*0860*/ SHF.R.U32.HI R10, RZ, 0x4, R10 ;
/*0870*/ SHF.R.U32.HI R9, RZ, 0x4, R9 ;
/*0880*/ LOP3.LUT R10, R10, 0x10000, RZ, 0xfc, !PT ;
/*0890*/ LOP3.LUT R12, R9, 0x2000000, RZ, 0xfc, !PT ;
/*08a0*/ VIADD R9, R7, 0x20 ;
/*08b0*/ R2UR UR8, R10 ;
/*08c0*/ VIADD R10, R8, 0x4800 ;
/*08d0*/ R2UR UR9, R11 ;
/*08e0*/ IMAD.MOV.U32 R11, RZ, RZ, 0x40000040 ;
/*08f0*/ R2UR UR10, R12 ;
/*0900*/ R2UR UR11, R13 ;
/*0910*/ IMAD.MOV.U32 R13, RZ, RZ, 0x40000040 ;
/*0920*/ LOP3.LUT R9, R9, 0x3fc20, RZ, 0xc0, !PT ;
/*0930*/ LOP3.LUT R10, R10, 0x3fc00, RZ, 0xc0, !PT ;
/*0940*/ SHF.R.U32.HI R9, RZ, 0x4, R9 ;
/*0950*/ SHF.R.U32.HI R12, RZ, 0x4, R10 ;
/*0960*/ LOP3.LUT R10, R9, 0x10000, RZ, 0xfc, !PT ;
/*0970*/ VIADD R9, R7, 0x40 ;
/*0980*/ LOP3.LUT R12, R12, 0x2000000, RZ, 0xfc, !PT ;
/*0990*/ HGMMA.64x128x16.F32.BF16 R24, gdesc[UR8].tnspB, R24 ;
/*09a0*/ R2UR UR8, R10 ;
/*09b0*/ VIADD R10, R8, 0x5000 ;
/*09c0*/ R2UR UR9, R11 ;
/*09d0*/ IMAD.MOV.U32 R11, RZ, RZ, 0x40000040 ;
/*09e0*/ R2UR UR10, R12 ;
/*09f0*/ VIADD R7, R7, 0x60 ;
/*0a00*/ R2UR UR11, R13 ;
/*0a10*/ IMAD.MOV.U32 R13, RZ, RZ, 0x40000040 ;
/*0a20*/ LOP3.LUT R9, R9, 0x3fc40, RZ, 0xc0, !PT ;
/*0a30*/ VIADD R8, R8, 0x5800 ;
/*0a40*/ LOP3.LUT R10, R10, 0x3fc00, RZ, 0xc0, !PT ;
/*0a50*/ SHF.R.U32.HI R9, RZ, 0x4, R9 ;
/*0a60*/ SHF.R.U32.HI R12, RZ, 0x4, R10 ;
/*0a70*/ LOP3.LUT R10, R9, 0x10000, RZ, 0xfc, !PT ;
/*0a80*/ IMAD.MOV.U32 R9, RZ, RZ, 0x40000040 ;
/*0a90*/ LOP3.LUT R12, R12, 0x2000000, RZ, 0xfc, !PT ;
/*0aa0*/ LOP3.LUT R7, R7, 0x3fc60, RZ, 0xc0, !PT ;
/*0ab0*/ LOP3.LUT R8, R8, 0x3fc00, RZ, 0xc0, !PT ;
/*0ac0*/ SHF.R.U32.HI R7, RZ, 0x4, R7 ;
/*0ad0*/ HGMMA.64x128x16.F32.BF16 R24, gdesc[UR8].tnspB, R24 ;
/*0ae0*/ R2UR UR8, R10 ;
/*0af0*/ R2UR UR9, R11 ;
/*0b00*/ IMAD.MOV.U32 R11, RZ, RZ, 0x40000040 ;
/*0b10*/ R2UR UR10, R12 ;
/*0b20*/ R2UR UR11, R13 ;
/*0b30*/ SHF.R.U32.HI R10, RZ, 0x4, R8 ;
/*0b40*/ LOP3.LUT R8, R7, 0x10000, RZ, 0xfc, !PT ;
/*0b50*/ LOP3.LUT R10, R10, 0x2000000, RZ, 0xfc, !PT ;
/*0b60*/ HGMMA.64x128x16.F32.BF16 R24, gdesc[UR8].tnspB, R24 ;
/*0b70*/ R2UR UR8, R8 ;
/*0b80*/ R2UR UR9, R9 ;
/*0b90*/ R2UR UR10, R10 ;
/*0ba0*/ R2UR UR11, R11 ;
/*0bb0*/ HGMMA.64x128x16.F32.BF16 R24, gdesc[UR8].tnspB, R24, gsb0 ;
/*0bc0*/ WARPGROUP.DEPBAR.LE gsb0, 0x0 ;
/*0bd0*/ VIADD R3, R3, 0x1 ;
/*0be0*/ SYNCS.ARRIVE.TRANS64.A1T0 RZ, [R6+URZ+0x20020], RZ ;
/*0bf0*/ ISETP.GE.AND P0, PT, R3, R2, PT ;
/*0c00*/ @!P0 BRA 0x700 ;
/*0c10*/ BSYNC B0 ;
/*0c20*/ LDC R11, c[0x0][0x348] ;
/*0c30*/ ISETP.GE.AND P0, PT, R0, R11, PT ;
/*0c40*/ @P0 EXIT ;
/*0c50*/ S2R R3, SR_TID.X ;
/*0c60*/ S2UR UR4, SR_CTAID.Z ;
/*0c70*/ SHF.R.S32.HI R2, RZ, 0x1f, R11 ;
/*0c80*/ BSSY B0, 0xf80 ;
/*0c90*/ S2R R13, SR_CTAID.X ;
/*0ca0*/ LDC R5, c[0x0][0x34c] ;
/*0cb0*/ IMAD R7, R2, UR4, RZ ;
/*0cc0*/ IMAD.WIDE.U32 R8, R11, UR4, RZ ;
/*0cd0*/ IMAD.IADD R10, R9, 0x1, R7 ;
/*0ce0*/ LOP3.LUT R2, R3.reuse, 0x60, RZ, 0xc0, !PT ;
/*0cf0*/ IMAD.SHL.U32 R4, R3.reuse, 0x2, RZ ;
/*0d00*/ LOP3.LUT R3, R3, 0x1f, RZ, 0xc0, !PT ;
/*0d10*/ LDC.64 R6, c[0x0][0x340] ;
/*0d20*/ SHF.R.U32.HI R2, RZ, 0x1, R2 ;
/*0d30*/ IMAD R10, R10, R5, RZ ;
/*0d40*/ LOP3.LUT R4, R4, 0x6, RZ, 0xc0, !PT ;
/*0d50*/ LEA.HI R9, R3, R2, RZ, 0x1e ;
/*0d60*/ SHF.R.S32.HI R15, RZ, 0x1f, R5 ;
/*0d70*/ IMAD R2, R13, 0x80, R4 ;
/*0d80*/ IMAD.IADD R0, R0, 0x1, R9 ;
/*0d90*/ IMAD R13, R15, R8, R10 ;
/*0da0*/ SHF.R.S32.HI R3, RZ, 0x1f, R2.reuse ;
/*0db0*/ VIADD R4, R0.reuse, 0x8 ;
/*0dc0*/ ISETP.GE.AND P0, PT, R0, R11, PT ;
/*0dd0*/ IMAD.WIDE.U32 R8, R8, R5, R2 ;
/*0de0*/ SHF.R.S32.HI R10, RZ, 0x1f, R4 ;
/*0df0*/ ISETP.GE.AND P1, PT, R4, R11, PT ;
/*0e00*/ IMAD.IADD R9, R9, 0x1, R13 ;
/*0e10*/ IMAD R10, R10, R5.reuse, RZ ;
/*0e20*/ IMAD.WIDE R12, R0, R5, R8 ;
/*0e30*/ IMAD R17, R4.reuse, R15, R10 ;
/*0e40*/ IMAD.WIDE.U32 R14, R4, R5, R8 ;
/*0e50*/ LEA R8, P2, R12, R6, 0x1 ;
/*0e60*/ IMAD.IADD R0, R15, 0x1, R17 ;
/*0e70*/ LEA.HI.X R9, R12, R7, R13, 0x1, P2 ;
/*0e80*/ LDC.64 R12, c[0x0][0x208] ;
/*0e90*/ LEA R6, P3, R14, R6, 0x1 ;
/*0ea0*/ LEA.HI.X R7, R14, R7, R0, 0x1, P3 ;
/*0eb0*/ @P0 BRA 0xf70 ;
/*0ec0*/ VIADD R0, R2.reuse, 0x1 ;
/*0ed0*/ ISETP.GE.AND P2, PT, R2, R5, PT ;
/*0ee0*/ ISETP.GE.AND P3, PT, R0, R5, PT ;
/*0ef0*/ @!P2 R2UR UR4, R12.reuse ;
/*0f00*/ @!P2 R2UR UR5, R13.reuse ;
/*0f10*/ @!P3 R2UR UR8, R12 ;
/*0f20*/ @!P3 R2UR UR9, R13 ;
/*0f30*/ @!P2 F2FP.BF16.F32.PACK_AB R24, RZ, R24 ;
/*0f40*/ @!P3 F2FP.BF16.F32.PACK_AB R25, RZ, R25 ;
/*0f50*/ @!P2 STG.E.U16 desc[UR4][R8.64], R24 ;
/*0f60*/ @!P3 STG.E.U16 desc[UR8][R8.64+0x2], R25 ;
/*0f70*/ BSYNC B0 ;
/*0f80*/ BSSY B0, 0x1080 ;
/*0f90*/ VIADD R4, R2.reuse, 0x68 ;
/*0fa0*/ VIADD R0, R2, 0x70 ;
/*0fb0*/ @P1 BRA 0x1070 ;
/*0fc0*/ VIADD R10, R2.reuse, 0x1 ;
/*0fd0*/ ISETP.GE.AND P2, PT, R2, R5, PT ;
/*0fe0*/ ISETP.GE.AND P3, PT, R10, R5, PT ;
/*0ff0*/ @!P2 R2UR UR4, R12.reuse ;
/*1000*/ @!P2 R2UR UR5, R13.reuse ;
/*1010*/ @!P3 R2UR UR8, R12 ;
/*1020*/ @!P3 R2UR UR9, R13 ;
/*1030*/ @!P2 F2FP.BF16.F32.PACK_AB R26, RZ, R26 ;
/*1040*/ @!P3 F2FP.BF16.F32.PACK_AB R27, RZ, R27 ;
/*1050*/ @!P2 STG.E.U16 desc[UR4][R6.64], R26 ;
/*1060*/ @!P3 STG.E.U16 desc[UR8][R6.64+0x2], R27 ;
/*1070*/ BSYNC B0 ;
/*1080*/ BSSY B0, 0x1170 ;
/*1090*/ VIADD R10, R2, 0x8 ;
/*10a0*/ @P0 BRA 0x1160 ;
/*10b0*/ VIADD R14, R2, 0x9 ;
/*10c0*/ ISETP.GE.AND P2, PT, R10, R5, PT ;
/*10d0*/ ISETP.GE.AND P3, PT, R14, R5, PT ;
/*10e0*/ @!P2 R2UR UR4, R12.reuse ;
/*10f0*/ @!P2 R2UR UR5, R13.reuse ;
/*1100*/ @!P3 R2UR UR8, R12 ;
/*1110*/ @!P3 R2UR UR9, R13 ;
/*1120*/ @!P2 F2FP.BF16.F32.PACK_AB R28, RZ, R28 ;
/*1130*/ @!P3 F2FP.BF16.F32.PACK_AB R29, RZ, R29 ;
/*1140*/ @!P2 STG.E.U16 desc[UR4][R8.64+0x10], R28 ;
/*1150*/ @!P3 STG.E.U16 desc[UR8][R8.64+0x12], R29 ;
/*1160*/ BSYNC B0 ;
/*1170*/ BSSY B0, 0x1250 ;
/*1180*/ @P1 BRA 0x1240 ;
/*1190*/ VIADD R14, R2, 0x9 ;
/*11a0*/ ISETP.GE.AND P2, PT, R10, R5, PT ;
/*11b0*/ ISETP.GE.AND P3, PT, R14, R5, PT ;
/*11c0*/ @!P2 R2UR UR4, R12.reuse ;
/*11d0*/ @!P2 R2UR UR5, R13.reuse ;
/*11e0*/ @!P3 R2UR UR8, R12 ;
/*11f0*/ @!P3 R2UR UR9, R13 ;
/*1200*/ @!P2 F2FP.BF16.F32.PACK_AB R30, RZ, R30 ;
/*1210*/ @!P3 F2FP.BF16.F32.PACK_AB R31, RZ, R31 ;
/*1220*/ @!P2 STG.E.U16 desc[UR4][R6.64+0x10], R30 ;
/*1230*/ @!P3 STG.E.U16 desc[UR8][R6.64+0x12], R31 ;
/*1240*/ BSYNC B0 ;
/*1250*/ BSSY B0, 0x1340 ;
/*1260*/ VIADD R10, R2, 0x10 ;
/*1270*/ @P0 BRA 0x1330 ;
/*1280*/ VIADD R14, R2, 0x11 ;
/*1290*/ ISETP.GE.AND P2, PT, R10, R5, PT ;
/*12a0*/ ISETP.GE.AND P3, PT, R14, R5, PT ;
/*12b0*/ @!P2 R2UR UR4, R12.reuse ;
/*12c0*/ @!P2 R2UR UR5, R13.reuse ;
/*12d0*/ @!P3 R2UR UR8, R12 ;
/*12e0*/ @!P3 R2UR UR9, R13 ;
/*12f0*/ @!P2 F2FP.BF16.F32.PACK_AB R32, RZ, R32 ;
/*1300*/ @!P3 F2FP.BF16.F32.PACK_AB R33, RZ, R33 ;
/*1310*/ @!P2 STG.E.U16 desc[UR4][R8.64+0x20], R32 ;
/*1320*/ @!P3 STG.E.U16 desc[UR8][R8.64+0x22], R33 ;
/*1330*/ BSYNC B0 ;
/*1340*/ BSSY B0, 0x1420 ;
/*1350*/ @P1 BRA 0x1410 ;
/*1360*/ VIADD R14, R2, 0x11 ;
/*1370*/ ISETP.GE.AND P2, PT, R10, R5, PT ;
/*1380*/ ISETP.GE.AND P3, PT, R14, R5, PT ;
/*1390*/ @!P2 R2UR UR4, R12.reuse ;
/*13a0*/ @!P2 R2UR UR5, R13.reuse ;
/*13b0*/ @!P3 R2UR UR8, R12 ;
/*13c0*/ @!P3 R2UR UR9, R13 ;
/*13d0*/ @!P2 F2FP.BF16.F32.PACK_AB R34, RZ, R34 ;
/*13e0*/ @!P3 F2FP.BF16.F32.PACK_AB R35, RZ, R35 ;
/*13f0*/ @!P2 STG.E.U16 desc[UR4][R6.64+0x20], R34 ;
/*1400*/ @!P3 STG.E.U16 desc[UR8][R6.64+0x22], R35 ;
/*1410*/ BSYNC B0 ;
/*1420*/ BSSY B0, 0x1510 ;
/*1430*/ VIADD R10, R2, 0x18 ;
/*1440*/ @P0 BRA 0x1500 ;
/*1450*/ VIADD R14, R2, 0x19 ;
/*1460*/ ISETP.GE.AND P2, PT, R10, R5, PT ;
/*1470*/ ISETP.GE.AND P3, PT, R14, R5, PT ;
/*1480*/ @!P2 R2UR UR4, R12.reuse ;
/*1490*/ @!P2 R2UR UR5, R13.reuse ;
/*14a0*/ @!P3 R2UR UR8, R12 ;
/*14b0*/ @!P3 R2UR UR9, R13 ;
/*14c0*/ @!P2 F2FP.BF16.F32.PACK_AB R36, RZ, R36 ;
/*14d0*/ @!P3 F2FP.BF16.F32.PACK_AB R37, RZ, R37 ;
/*14e0*/ @!P2 STG.E.U16 desc[UR4][R8.64+0x30], R36 ;
/*14f0*/ @!P3 STG.E.U16 desc[UR8][R8.64+0x32], R37 ;
/*1500*/ BSYNC B0 ;
/*1510*/ BSSY B0, 0x15f0 ;
/*1520*/ @P1 BRA 0x15e0 ;
/*1530*/ VIADD R14, R2, 0x19 ;
/*1540*/ ISETP.GE.AND P2, PT, R10, R5, PT ;
/*1550*/ ISETP.GE.AND P3, PT, R14, R5, PT ;
/*1560*/ @!P2 R2UR UR4, R12.reuse ;
/*1570*/ @!P2 R2UR UR5, R13.reuse ;
/*1580*/ @!P3 R2UR UR8, R12 ;
/*1590*/ @!P3 R2UR UR9, R13 ;
/*15a0*/ @!P2 F2FP.BF16.F32.PACK_AB R38, RZ, R38 ;
/*15b0*/ @!P3 F2FP.BF16.F32.PACK_AB R39, RZ, R39 ;
/*15c0*/ @!P2 STG.E.U16 desc[UR4][R6.64+0x30], R38 ;
/*15d0*/ @!P3 STG.E.U16 desc[UR8][R6.64+0x32], R39 ;
/*15e0*/ BSYNC B0 ;
/*15f0*/ BSSY B0, 0x16e0 ;
/*1600*/ VIADD R10, R2, 0x20 ;
/*1610*/ @P0 BRA 0x16d0 ;
/*1620*/ VIADD R14, R2, 0x21 ;
/*1630*/ ISETP.GE.AND P2, PT, R10, R5, PT ;
/*1640*/ ISETP.GE.AND P3, PT, R14, R5, PT ;
/*1650*/ @!P2 R2UR UR4, R12.reuse ;
/*1660*/ @!P2 R2UR UR5, R13.reuse ;
/*1670*/ @!P3 R2UR UR8, R12 ;
/*1680*/ @!P3 R2UR UR9, R13 ;
/*1690*/ @!P2 F2FP.BF16.F32.PACK_AB R40, RZ, R40 ;
/*16a0*/ @!P3 F2FP.BF16.F32.PACK_AB R41, RZ, R41 ;
/*16b0*/ @!P2 STG.E.U16 desc[UR4][R8.64+0x40], R40 ;
/*16c0*/ @!P3 STG.E.U16 desc[UR8][R8.64+0x42], R41 ;
/*16d0*/ BSYNC B0 ;
/*16e0*/ BSSY B0, 0x17c0 ;
/*16f0*/ @P1 BRA 0x17b0 ;
/*1700*/ VIADD R14, R2, 0x21 ;
/*1710*/ ISETP.GE.AND P2, PT, R10, R5, PT ;
/*1720*/ ISETP.GE.AND P3, PT, R14, R5, PT ;
/*1730*/ @!P2 R2UR UR4, R12.reuse ;
/*1740*/ @!P2 R2UR UR5, R13.reuse ;
/*1750*/ @!P3 R2UR UR8, R12 ;
/*1760*/ @!P3 R2UR UR9, R13 ;
/*1770*/ @!P2 F2FP.BF16.F32.PACK_AB R42, RZ, R42 ;
/*1780*/ @!P3 F2FP.BF16.F32.PACK_AB R43, RZ, R43 ;
/*1790*/ @!P2 STG.E.U16 desc[UR4][R6.64+0x40], R42 ;
/*17a0*/ @!P3 STG.E.U16 desc[UR8][R6.64+0x42], R43 ;
/*17b0*/ BSYNC B0 ;
/*17c0*/ BSSY B0, 0x18b0 ;
/*17d0*/ VIADD R10, R2, 0x28 ;
/*17e0*/ @P0 BRA 0x18a0 ;
/*17f0*/ VIADD R14, R2, 0x29 ;
/*1800*/ ISETP.GE.AND P2, PT, R10, R5, PT ;
/*1810*/ ISETP.GE.AND P3, PT, R14, R5, PT ;
/*1820*/ @!P2 R2UR UR4, R12.reuse ;
/*1830*/ @!P2 R2UR UR5, R13.reuse ;
/*1840*/ @!P3 R2UR UR8, R12 ;
/*1850*/ @!P3 R2UR UR9, R13 ;
/*1860*/ @!P2 F2FP.BF16.F32.PACK_AB R44, RZ, R44 ;
/*1870*/ @!P3 F2FP.BF16.F32.PACK_AB R45, RZ, R45 ;
/*1880*/ @!P2 STG.E.U16 desc[UR4][R8.64+0x50], R44 ;
/*1890*/ @!P3 STG.E.U16 desc[UR8][R8.64+0x52], R45 ;
/*18a0*/ BSYNC B0 ;
/*18b0*/ BSSY B0, 0x1990 ;
/*18c0*/ @P1 BRA 0x1980 ;
/*18d0*/ VIADD R14, R2, 0x29 ;
/*18e0*/ ISETP.GE.AND P2, PT, R10, R5, PT ;
/*18f0*/ ISETP.GE.AND P3, PT, R14, R5, PT ;
/*1900*/ @!P2 R2UR UR4, R12.reuse ;
/*1910*/ @!P2 R2UR UR5, R13.reuse ;
/*1920*/ @!P3 R2UR UR8, R12 ;
/*1930*/ @!P3 R2UR UR9, R13 ;
/*1940*/ @!P2 F2FP.BF16.F32.PACK_AB R46, RZ, R46 ;
/*1950*/ @!P3 F2FP.BF16.F32.PACK_AB R47, RZ, R47 ;
/*1960*/ @!P2 STG.E.U16 desc[UR4][R6.64+0x50], R46 ;
/*1970*/ @!P3 STG.E.U16 desc[UR8][R6.64+0x52], R47 ;
/*1980*/ BSYNC B0 ;
/*1990*/ BSSY B0, 0x1a80 ;
/*19a0*/ VIADD R10, R2, 0x30 ;
/*19b0*/ @P0 BRA 0x1a70 ;
/*19c0*/ VIADD R14, R2, 0x31 ;
/*19d0*/ ISETP.GE.AND P2, PT, R10, R5, PT ;
/*19e0*/ ISETP.GE.AND P3, PT, R14, R5, PT ;
/*19f0*/ @!P2 R2UR UR4, R12.reuse ;
/*1a00*/ @!P2 R2UR UR5, R13.reuse ;
/*1a10*/ @!P3 R2UR UR8, R12 ;
/*1a20*/ @!P3 R2UR UR9, R13 ;
/*1a30*/ @!P2 F2FP.BF16.F32.PACK_AB R48, RZ, R48 ;
/*1a40*/ @!P3 F2FP.BF16.F32.PACK_AB R49, RZ, R49 ;
/*1a50*/ @!P2 STG.E.U16 desc[UR4][R8.64+0x60], R48 ;
/*1a60*/ @!P3 STG.E.U16 desc[UR8][R8.64+0x62], R49 ;
/*1a70*/ BSYNC B0 ;
/*1a80*/ BSSY B0, 0x1b60 ;
/*1a90*/ @P1 BRA 0x1b50 ;
/*1aa0*/ VIADD R14, R2, 0x31 ;
/*1ab0*/ ISETP.GE.AND P2, PT, R10, R5, PT ;
/*1ac0*/ ISETP.GE.AND P3, PT, R14, R5, PT ;
/*1ad0*/ @!P2 R2UR UR4, R12.reuse ;
/*1ae0*/ @!P2 R2UR UR5, R13.reuse ;
/*1af0*/ @!P3 R2UR UR8, R12 ;
/*1b00*/ @!P3 R2UR UR9, R13 ;
/*1b10*/ @!P2 F2FP.BF16.F32.PACK_AB R50, RZ, R50 ;
/*1b20*/ @!P3 F2FP.BF16.F32.PACK_AB R51, RZ, R51 ;
/*1b30*/ @!P2 STG.E.U16 desc[UR4][R6.64+0x60], R50 ;
/*1b40*/ @!P3 STG.E.U16 desc[UR8][R6.64+0x62], R51 ;
/*1b50*/ BSYNC B0 ;
/*1b60*/ BSSY B0, 0x1c50 ;
/*1b70*/ VIADD R10, R2, 0x38 ;
/*1b80*/ @P0 BRA 0x1c40 ;
/*1b90*/ VIADD R14, R2, 0x39 ;
/*1ba0*/ ISETP.GE.AND P2, PT, R10, R5, PT ;
/*1bb0*/ ISETP.GE.AND P3, PT, R14, R5, PT ;
/*1bc0*/ @!P2 R2UR UR4, R12.reuse ;
/*1bd0*/ @!P2 R2UR UR5, R13.reuse ;
/*1be0*/ @!P3 R2UR UR8, R12 ;
/*1bf0*/ @!P3 R2UR UR9, R13 ;
/*1c00*/ @!P2 F2FP.BF16.F32.PACK_AB R52, RZ, R52 ;
/*1c10*/ @!P3 F2FP.BF16.F32.PACK_AB R53, RZ, R53 ;
/*1c20*/ @!P2 STG.E.U16 desc[UR4][R8.64+0x70], R52 ;
/*1c30*/ @!P3 STG.E.U16 desc[UR8][R8.64+0x72], R53 ;
/*1c40*/ BSYNC B0 ;
/*1c50*/ BSSY B0, 0x1d30 ;
/*1c60*/ @P1 BRA 0x1d20 ;
/*1c70*/ VIADD R14, R2, 0x39 ;
/*1c80*/ ISETP.GE.AND P2, PT, R10, R5, PT ;
/*1c90*/ ISETP.GE.AND P3, PT, R14, R5, PT ;
/*1ca0*/ @!P2 R2UR UR4, R12.reuse ;
/*1cb0*/ @!P2 R2UR UR5, R13.reuse ;
/*1cc0*/ @!P3 R2UR UR8, R12 ;
/*1cd0*/ @!P3 R2UR UR9, R13 ;
/*1ce0*/ @!P2 F2FP.BF16.F32.PACK_AB R54, RZ, R54 ;
/*1cf0*/ @!P3 F2FP.BF16.F32.PACK_AB R55, RZ, R55 ;
/*1d00*/ @!P2 STG.E.U16 desc[UR4][R6.64+0x70], R54 ;
/*1d10*/ @!P3 STG.E.U16 desc[UR8][R6.64+0x72], R55 ;
/*1d20*/ BSYNC B0 ;
/*1d30*/ BSSY B0, 0x1e20 ;
/*1d40*/ VIADD R10, R2, 0x40 ;
/*1d50*/ @P0 BRA 0x1e10 ;
/*1d60*/ VIADD R14, R2, 0x41 ;
/*1d70*/ ISETP.GE.AND P2, PT, R10, R5, PT ;
/*1d80*/ ISETP.GE.AND P3, PT, R14, R5, PT ;
/*1d90*/ @!P2 R2UR UR4, R12.reuse ;
/*1da0*/ @!P2 R2UR UR5, R13.reuse ;
/*1db0*/ @!P3 R2UR UR8, R12 ;
/*1dc0*/ @!P3 R2UR UR9, R13 ;
/*1dd0*/ @!P2 F2FP.BF16.F32.PACK_AB R56, RZ, R56 ;
/*1de0*/ @!P3 F2FP.BF16.F32.PACK_AB R57, RZ, R57 ;
/*1df0*/ @!P2 STG.E.U16 desc[UR4][R8.64+0x80], R56 ;
/*1e00*/ @!P3 STG.E.U16 desc[UR8][R8.64+0x82], R57 ;
/*1e10*/ BSYNC B0 ;
/*1e20*/ BSSY B0, 0x1f00 ;
/*1e30*/ @P1 BRA 0x1ef0 ;
/*1e40*/ VIADD R14, R2, 0x41 ;
/*1e50*/ ISETP.GE.AND P2, PT, R10, R5, PT ;
/*1e60*/ ISETP.GE.AND P3, PT, R14, R5, PT ;
/*1e70*/ @!P2 R2UR UR4, R12.reuse ;
/*1e80*/ @!P2 R2UR UR5, R13.reuse ;
/*1e90*/ @!P3 R2UR UR8, R12 ;
/*1ea0*/ @!P3 R2UR UR9, R13 ;
/*1eb0*/ @!P2 F2FP.BF16.F32.PACK_AB R58, RZ, R58 ;
/*1ec0*/ @!P3 F2FP.BF16.F32.PACK_AB R59, RZ, R59 ;
/*1ed0*/ @!P2 STG.E.U16 desc[UR4][R6.64+0x80], R58 ;
/*1ee0*/ @!P3 STG.E.U16 desc[UR8][R6.64+0x82], R59 ;
/*1ef0*/ BSYNC B0 ;
/*1f00*/ BSSY B0, 0x1ff0 ;
/*1f10*/ VIADD R10, R2, 0x48 ;
/*1f20*/ @P0 BRA 0x1fe0 ;
/*1f30*/ VIADD R14, R2, 0x49 ;
/*1f40*/ ISETP.GE.AND P2, PT, R10, R5, PT ;
/*1f50*/ ISETP.GE.AND P3, PT, R14, R5, PT ;
/*1f60*/ @!P2 R2UR UR4, R12.reuse ;
/*1f70*/ @!P2 R2UR UR5, R13.reuse ;
/*1f80*/ @!P3 R2UR UR8, R12 ;
/*1f90*/ @!P3 R2UR UR9, R13 ;
/*1fa0*/ @!P2 F2FP.BF16.F32.PACK_AB R60, RZ, R60 ;
/*1fb0*/ @!P3 F2FP.BF16.F32.PACK_AB R61, RZ, R61 ;
/*1fc0*/ @!P2 STG.E.U16 desc[UR4][R8.64+0x90], R60 ;
/*1fd0*/ @!P3 STG.E.U16 desc[UR8][R8.64+0x92], R61 ;
/*1fe0*/ BSYNC B0 ;
/*1ff0*/ BSSY B0, 0x20d0 ;
/*2000*/ @P1 BRA 0x20c0 ;
/*2010*/ VIADD R14, R2, 0x49 ;
/*2020*/ ISETP.GE.AND P2, PT, R10, R5, PT ;
/*2030*/ ISETP.GE.AND P3, PT, R14, R5, PT ;
/*2040*/ @!P2 R2UR UR4, R12.reuse ;
/*2050*/ @!P2 R2UR UR5, R13.reuse ;
/*2060*/ @!P3 R2UR UR8, R12 ;
/*2070*/ @!P3 R2UR UR9, R13 ;
/*2080*/ @!P2 F2FP.BF16.F32.PACK_AB R62, RZ, R62 ;
/*2090*/ @!P3 F2FP.BF16.F32.PACK_AB R63, RZ, R63 ;
/*20a0*/ @!P2 STG.E.U16 desc[UR4][R6.64+0x90], R62 ;
/*20b0*/ @!P3 STG.E.U16 desc[UR8][R6.64+0x92], R63 ;
/*20c0*/ BSYNC B0 ;
/*20d0*/ BSSY B0, 0x21c0 ;
/*20e0*/ VIADD R10, R2, 0x50 ;
/*20f0*/ @P0 BRA 0x21b0 ;
/*2100*/ VIADD R14, R2, 0x51 ;
/*2110*/ ISETP.GE.AND P2, PT, R10, R5, PT ;
/*2120*/ ISETP.GE.AND P3, PT, R14, R5, PT ;
/*2130*/ @!P2 R2UR UR4, R12.reuse ;
/*2140*/ @!P2 R2UR UR5, R13.reuse ;
/*2150*/ @!P3 R2UR UR8, R12 ;
/*2160*/ @!P3 R2UR UR9, R13 ;
/*2170*/ @!P2 F2FP.BF16.F32.PACK_AB R64, RZ, R64 ;
/*2180*/ @!P3 F2FP.BF16.F32.PACK_AB R65, RZ, R65 ;
/*2190*/ @!P2 STG.E.U16 desc[UR4][R8.64+0xa0], R64 ;
/*21a0*/ @!P3 STG.E.U16 desc[UR8][R8.64+0xa2], R65 ;
/*21b0*/ BSYNC B0 ;
/*21c0*/ BSSY B0, 0x22a0 ;
/*21d0*/ @P1 BRA 0x2290 ;
/*21e0*/ VIADD R14, R2, 0x51 ;
/*21f0*/ ISETP.GE.AND P2, PT, R10, R5, PT ;
/*2200*/ ISETP.GE.AND P3, PT, R14, R5, PT ;
/*2210*/ @!P2 R2UR UR4, R12.reuse ;
/*2220*/ @!P2 R2UR UR5, R13.reuse ;
/*2230*/ @!P3 R2UR UR8, R12 ;
/*2240*/ @!P3 R2UR UR9, R13 ;
/*2250*/ @!P2 F2FP.BF16.F32.PACK_AB R66, RZ, R66 ;
/*2260*/ @!P3 F2FP.BF16.F32.PACK_AB R67, RZ, R67 ;
/*2270*/ @!P2 STG.E.U16 desc[UR4][R6.64+0xa0], R66 ;
/*2280*/ @!P3 STG.E.U16 desc[UR8][R6.64+0xa2], R67 ;
/*2290*/ BSYNC B0 ;
/*22a0*/ BSSY B0, 0x2390 ;
/*22b0*/ VIADD R10, R2, 0x58 ;
/*22c0*/ @P0 BRA 0x2380 ;
/*22d0*/ VIADD R14, R2, 0x59 ;
/*22e0*/ ISETP.GE.AND P2, PT, R10, R5, PT ;
/*22f0*/ ISETP.GE.AND P3, PT, R14, R5, PT ;
/*2300*/ @!P2 R2UR UR4, R12.reuse ;
/*2310*/ @!P2 R2UR UR5, R13.reuse ;
/*2320*/ @!P3 R2UR UR8, R12 ;
/*2330*/ @!P3 R2UR UR9, R13 ;
/*2340*/ @!P2 F2FP.BF16.F32.PACK_AB R68, RZ, R68 ;
/*2350*/ @!P3 F2FP.BF16.F32.PACK_AB R69, RZ, R69 ;
/*2360*/ @!P2 STG.E.U16 desc[UR4][R8.64+0xb0], R68 ;
/*2370*/ @!P3 STG.E.U16 desc[UR8][R8.64+0xb2], R69 ;
/*2380*/ BSYNC B0 ;
/*2390*/ BSSY B0, 0x2470 ;
/*23a0*/ @P1 BRA 0x2460 ;
/*23b0*/ VIADD R14, R2, 0x59 ;
/*23c0*/ ISETP.GE.AND P2, PT, R10, R5, PT ;
/*23d0*/ ISETP.GE.AND P3, PT, R14, R5, PT ;
/*23e0*/ @!P2 R2UR UR4, R12.reuse ;
/*23f0*/ @!P2 R2UR UR5, R13.reuse ;
/*2400*/ @!P3 R2UR UR8, R12 ;
/*2410*/ @!P3 R2UR UR9, R13 ;
/*2420*/ @!P2 F2FP.BF16.F32.PACK_AB R70, RZ, R70 ;
/*2430*/ @!P3 F2FP.BF16.F32.PACK_AB R71, RZ, R71 ;
/*2440*/ @!P2 STG.E.U16 desc[UR4][R6.64+0xb0], R70 ;
/*2450*/ @!P3 STG.E.U16 desc[UR8][R6.64+0xb2], R71 ;
/*2460*/ BSYNC B0 ;
/*2470*/ BSSY B0, 0x2560 ;
/*2480*/ VIADD R10, R2, 0x60 ;
/*2490*/ @P0 BRA 0x2550 ;
/*24a0*/ VIADD R14, R2, 0x61 ;
/*24b0*/ ISETP.GE.AND P2, PT, R10, R5, PT ;
/*24c0*/ ISETP.GE.AND P3, PT, R14, R5, PT ;
/*24d0*/ @!P2 R2UR UR4, R12.reuse ;
/*24e0*/ @!P2 R2UR UR5, R13.reuse ;
/*24f0*/ @!P3 R2UR UR8, R12 ;
/*2500*/ @!P3 R2UR UR9, R13 ;
/*2510*/ @!P2 F2FP.BF16.F32.PACK_AB R72, RZ, R72 ;
/*2520*/ @!P3 F2FP.BF16.F32.PACK_AB R73, RZ, R73 ;
/*2530*/ @!P2 STG.E.U16 desc[UR4][R8.64+0xc0], R72 ;
/*2540*/ @!P3 STG.E.U16 desc[UR8][R8.64+0xc2], R73 ;
/*2550*/ BSYNC B0 ;
/*2560*/ BSSY B0, 0x2640 ;
/*2570*/ @P1 BRA 0x2630 ;
/*2580*/ VIADD R14, R2, 0x61 ;
/*2590*/ ISETP.GE.AND P2, PT, R10, R5, PT ;
/*25a0*/ ISETP.GE.AND P3, PT, R14, R5, PT ;
/*25b0*/ @!P2 R2UR UR4, R12.reuse ;
/*25c0*/ @!P2 R2UR UR5, R13.reuse ;
/*25d0*/ @!P3 R2UR UR8, R12 ;
/*25e0*/ @!P3 R2UR UR9, R13 ;
/*25f0*/ @!P2 F2FP.BF16.F32.PACK_AB R74, RZ, R74 ;
/*2600*/ @!P3 F2FP.BF16.F32.PACK_AB R75, RZ, R75 ;
/*2610*/ @!P2 STG.E.U16 desc[UR4][R6.64+0xc0], R74 ;
/*2620*/ @!P3 STG.E.U16 desc[UR8][R6.64+0xc2], R75 ;
/*2630*/ BSYNC B0 ;
/*2640*/ BSSY B0, 0x2730 ;
/*2650*/ VIADD R14, R2.reuse, 0x78 ;
/*2660*/ VIADD R10, R2, 0x69 ;
/*2670*/ @P0 BRA 0x2720 ;
/*2680*/ ISETP.GE.AND P2, PT, R4, R5.reuse, PT ;
/*2690*/ ISETP.GE.AND P3, PT, R10, R5, PT ;
/*26a0*/ @!P2 R2UR UR4, R12.reuse ;
/*26b0*/ @!P2 R2UR UR5, R13.reuse ;
/*26c0*/ @!P3 R2UR UR8, R12 ;
/*26d0*/ @!P3 R2UR UR9, R13 ;
/*26e0*/ @!P2 F2FP.BF16.F32.PACK_AB R76, RZ, R76 ;
/*26f0*/ @!P3 F2FP.BF16.F32.PACK_AB R77, RZ, R77 ;
/*2700*/ @!P2 STG.E.U16 desc[UR4][R8.64+0xd0], R76 ;
/*2710*/ @!P3 STG.E.U16 desc[UR8][R8.64+0xd2], R77 ;
/*2720*/ BSYNC B0 ;
/*2730*/ BSSY B0, 0x2800 ;
/*2740*/ @P1 BRA 0x27f0 ;
/*2750*/ ISETP.GE.AND P2, PT, R4, R5.reuse, PT ;
/*2760*/ ISETP.GE.AND P3, PT, R10, R5, PT ;
/*2770*/ @!P2 R2UR UR4, R12.reuse ;
/*2780*/ @!P2 R2UR UR5, R13.reuse ;
/*2790*/ @!P3 R2UR UR8, R12 ;
/*27a0*/ @!P3 R2UR UR9, R13 ;
/*27b0*/ @!P2 F2FP.BF16.F32.PACK_AB R78, RZ, R78 ;
/*27c0*/ @!P3 F2FP.BF16.F32.PACK_AB R79, RZ, R79 ;
/*27d0*/ @!P2 STG.E.U16 desc[UR4][R6.64+0xd0], R78 ;
/*27e0*/ @!P3 STG.E.U16 desc[UR8][R6.64+0xd2], R79 ;
/*27f0*/ BSYNC B0 ;
/*2800*/ BSSY B0, 0x28f0 ;
/*2810*/ VIADD R4, R2.reuse, 0x79 ;
/*2820*/ VIADD R2, R2, 0x71 ;
/*2830*/ @P0 BRA 0x28e0 ;
/*2840*/ ISETP.GE.AND P2, PT, R0, R5.reuse, PT ;
/*2850*/ ISETP.GE.AND P3, PT, R2, R5, PT ;
/*2860*/ @!P2 R2UR UR4, R12.reuse ;
/*2870*/ @!P2 R2UR UR5, R13.reuse ;
/*2880*/ @!P3 R2UR UR8, R12 ;
/*2890*/ @!P3 R2UR UR9, R13 ;
/*28a0*/ @!P2 F2FP.BF16.F32.PACK_AB R80, RZ, R80 ;
/*28b0*/ @!P3 F2FP.BF16.F32.PACK_AB R81, RZ, R81 ;
/*28c0*/ @!P2 STG.E.U16 desc[UR4][R8.64+0xe0], R80 ;
/*28d0*/ @!P3 STG.E.U16 desc[UR8][R8.64+0xe2], R81 ;
/*28e0*/ BSYNC B0 ;
/*28f0*/ BSSY B0, 0x29c0 ;
/*2900*/ @P1 BRA 0x29b0 ;
/*2910*/ ISETP.GE.AND P2, PT, R0, R5.reuse, PT ;
/*2920*/ ISETP.GE.AND P3, PT, R2, R5, PT ;
/*2930*/ @!P2 R2UR UR4, R12.reuse ;
/*2940*/ @!P2 R2UR UR5, R13.reuse ;
/*2950*/ @!P3 R2UR UR8, R12 ;
/*2960*/ @!P3 R2UR UR9, R13 ;
/*2970*/ @!P2 F2FP.BF16.F32.PACK_AB R82, RZ, R82 ;
/*2980*/ @!P3 F2FP.BF16.F32.PACK_AB R83, RZ, R83 ;
/*2990*/ @!P2 STG.E.U16 desc[UR4][R6.64+0xe0], R82 ;
/*29a0*/ @!P3 STG.E.U16 desc[UR8][R6.64+0xe2], R83 ;
/*29b0*/ BSYNC B0 ;
/*29c0*/ BSSY B0, 0x2a90 ;
/*29d0*/ @P0 BRA 0x2a80 ;
/*29e0*/ ISETP.GE.AND P0, PT, R14, R5.reuse, PT ;
/*29f0*/ ISETP.GE.AND P2, PT, R4, R5, PT ;
/*2a00*/ @!P0 R2UR UR4, R12.reuse ;
/*2a10*/ @!P0 R2UR UR5, R13.reuse ;
/*2a20*/ @!P2 R2UR UR8, R12 ;
/*2a30*/ @!P2 R2UR UR9, R13 ;
/*2a40*/ @!P0 F2FP.BF16.F32.PACK_AB R84, RZ, R84 ;
/*2a50*/ @!P2 F2FP.BF16.F32.PACK_AB R85, RZ, R85 ;
/*2a60*/ @!P0 STG.E.U16 desc[UR4][R8.64+0xf0], R84 ;
/*2a70*/ @!P2 STG.E.U16 desc[UR8][R8.64+0xf2], R85 ;
/*2a80*/ BSYNC B0 ;
/*2a90*/ @P1 EXIT ;
/*2aa0*/ ISETP.GE.AND P0, PT, R14, R5.reuse, PT ;
/*2ab0*/ ISETP.GE.AND P1, PT, R4, R5, PT ;
/*2ac0*/ @!P0 R2UR UR4, R12 ;
/*2ad0*/ @!P0 R2UR UR5, R13 ;
/*2ae0*/ @!P0 F2FP.BF16.F32.PACK_AB R86, RZ, R86 ;
/*2af0*/ @!P0 STG.E.U16 desc[UR4][R6.64+0xf0], R86 ;
/*2b00*/ @P1 EXIT ;
/*2b10*/ R2UR UR4, R12 ;
/*2b20*/ R2UR UR5, R13 ;
/*2b30*/ F2FP.BF16.F32.PACK_AB R87, RZ, R87 ;
/*2b40*/ STG.E.U16 desc[UR4][R6.64+0xf2], R87 ;
/*2b50*/ EXIT ;
/*2b60*/ ISETP.GE.AND P0, PT, R5, 0x1, PT ;
/*2b70*/ ISETP.NE.OR P0, PT, R4, RZ, !P0 ;
/*2b80*/ @P0 EXIT ;
/*2b90*/ S2R R4, SR_CgaCtaId ;
/*2ba0*/ MOV R3, 0x400 ;
/*2bb0*/ ULDC.64 UR4, c[0x0][0x198] ;
/*2bc0*/ IMAD.U32 R6, RZ, RZ, UR14 ;
/*2bd0*/ UIADD3 UR6, UP0, UR4, 0x30, URZ ;
/*2be0*/ IMAD.MOV.U32 R5, RZ, RZ, RZ ;
/*2bf0*/ UIADD3 UR9, UP1, UR4, 0xb0, URZ ;
/*2c00*/ IMAD.MOV.U32 R8, RZ, RZ, 0x8000 ;
/*2c10*/ UIADD3.X UR8, URZ, UR5, URZ, UP0, !UPT ;
/*2c20*/ UIADD3.X UR4, URZ, UR5, URZ, UP1, !UPT ;
/*2c30*/ IMAD.U32 R10, RZ, RZ, UR6 ;
/*2c40*/ IMAD.U32 R12, RZ, RZ, UR9 ;
/*2c50*/ IMAD.U32 R11, RZ, RZ, UR8 ;
/*2c60*/ IMAD.U32 R13, RZ, RZ, UR4 ;
/*2c70*/ LEA R3, R4, R3, 0x18 ;
/*2c80*/ VIADD R4, R3, 0x3ff ;
/*2c90*/ VIADD R3, R6, 0x40 ;
/*2ca0*/ LOP3.LUT R9, R4, 0xfffffc00, RZ, 0xc0, !PT ;
/*2cb0*/ ISETP.GT.U32.AND P0, PT, R5.reuse, 0x3, PT ;
/*2cc0*/ LOP3.LUT R6, R5, 0x3, RZ, 0xc0, !PT ;
/*2cd0*/ IMAD R14, R6, 0x8, R9 ;
/*2ce0*/ @!P0 BRA 0x2da0 ;
/*2cf0*/ S2UR UR5, SR_CgaCtaId ;
/*2d00*/ UMOV UR4, 0x400 ;
/*2d10*/ SHF.R.U32.HI R4, RZ, 0x2, R5 ;
/*2d20*/ LOP3.LUT R4, R4, 0x1, RZ, 0xc, !PT ;
/*2d30*/ IMAD.U32 R4, R4, -0x80000000, RZ ;
/*2d40*/ ULEA UR4, UR5, UR4, 0x18 ;
/*2d50*/ UIADD3 UR4, UR4, 0x3ff, URZ ;
/*2d60*/ ULOP3.LUT UR4, UR4, 0xfffffc00, URZ, 0xc0, !UPT ;
/*2d70*/ LEA R7, R6, UR4, 0x3 ;
/*2d80*/ SYNCS.PHASECHK.TRANS64.TRYWAIT P0, [R7+URZ+0x20020], R4 ;
/*2d90*/ @!P0 BRA 0x3080 ;
/*2da0*/ R2UR UR4, R6 ;
/*2db0*/ IMAD.IADD R4, R0, 0x1, R5 ;
/*2dc0*/ R2UR UR8, R9 ;
/*2dd0*/ R2UR UR5, R14 ;
/*2de0*/ R2UR UR6, R4 ;
/*2df0*/ R2UR UR9, R11 ;
/*2e00*/ PLOP3.LUT P0, PT, PT, PT, PT, 0x80, 0x0 ;
/*2e10*/ ULEA UR4, UR4, UR8, 0xf ;
/*2e20*/ R2UR UR8, R10 ;
/*2e30*/ SYNCS.ARRIVE.TRANS64 RZ, [UR5+0x20000], R8 ;
/*2e40*/ UIADD3 UR5, UR5, 0x20000, URZ ;
/*2e50*/ USHF.L.U32 UR6, UR6, 0x6, URZ ;
/*2e60*/ @P0 ELECT P1, URZ, PT ;
/*2e70*/ UTMALDG.2D [UR4], [UR8] ;
/*2e80*/ @P1 PLOP3.LUT P0, PT, P1, PT, PT, 0x8, 0x0 ;
/*2e90*/ PLOP3.LUT P1, PT, PT, PT, PT, 0x8, 0x0 ;
/*2ea0*/ @P0 BRA.U.ANY 0x2e60 ;
/*2eb0*/ R2UR UR18, R12 ;
/*2ec0*/ UIADD3 UR12, UR4, 0x4000, URZ ;
/*2ed0*/ R2UR UR19, R13 ;
/*2ee0*/ PLOP3.LUT P0, PT, PT, PT, PT, 0x80, 0x0 ;
/*2ef0*/ @P0 ELECT P1, URZ, PT ;
/*2f00*/ UMOV UR13, UR5 ;
/*2f10*/ UMOV UR15, UR6 ;
/*2f20*/ UTMALDG.2D [UR12], [UR18] ;
/*2f30*/ @P1 PLOP3.LUT P0, PT, P1, PT, PT, 0x8, 0x0 ;
/*2f40*/ PLOP3.LUT P1, PT, PT, PT, PT, 0x8, 0x0 ;
/*2f50*/ @P0 BRA.U.ANY 0x2ef0 ;
/*2f60*/ R2UR UR10, R3 ;
/*2f70*/ UIADD3 UR8, UR4, 0x6000, URZ ;
/*2f80*/ PLOP3.LUT P0, PT, PT, PT, PT, 0x80, 0x0 ;
/*2f90*/ @P0 ELECT P1, URZ, PT ;
/*2fa0*/ UMOV UR9, UR5 ;
/*2fb0*/ UMOV UR11, UR6 ;
/*2fc0*/ UTMALDG.2D [UR8], [UR18] ;
/*2fd0*/ @P1 PLOP3.LUT P0, PT, P1, PT, PT, 0x8, 0x0 ;
/*2fe0*/ PLOP3.LUT P1, PT, PT, PT, PT, 0x8, 0x0 ;
/*2ff0*/ @P0 BRA.U.ANY 0x2f90 ;
/*3000*/ VIADD R5, R5, 0x1 ;
/*3010*/ ISETP.GE.AND P0, PT, R5, R2, PT ;
/*3020*/ @!P0 BRA 0x2cb0 ;
/*3030*/ EXIT ;
/*3040*/ YIELD ;
/*3050*/ SYNCS.PHASECHK.TRANS64.TRYWAIT P0, [R6+URZ+0x20000], R7 ;
/*3060*/ @!P0 BRA 0x3040 ;
/*3070*/ BRA 0x790 ;
/*3080*/ YIELD ;
/*3090*/ SYNCS.PHASECHK.TRANS64.TRYWAIT P0, [R7+URZ+0x20020], R4 ;
/*30a0*/ @!P0 BRA 0x3080 ;
/*30b0*/ BRA 0x2da0 ;
/*30c0*/ BRA 0x30c0;
/*30d0*/ NOP;
/*30e0*/ NOP;
/*30f0*/ NOP;
/*3100*/ NOP;
/*3110*/ NOP;
/*3120*/ NOP;
/*3130*/ NOP;
/*3140*/ NOP;
/*3150*/ NOP;
/*3160*/ NOP;
/*3170*/ NOP;
"""

FUNCTION_NAMES = """\
_Z10rms_kernelI13__nv_bfloat16Li16EEvPKT_PKfPS1_iif
_Z10rms_kernelI13__nv_bfloat16Li1EEvPKT_PKfPS1_iif
_Z10rms_kernelI13__nv_bfloat16Li2EEvPKT_PKfPS1_iif
_Z10rms_kernelI13__nv_bfloat16Li4EEvPKT_PKfPS1_iif
_Z10rms_kernelI13__nv_bfloat16Li8EEvPKT_PKfPS1_iif
_Z10rms_kernelIfLi16EEvPKT_PKfPS0_iif
_Z10rms_kernelIfLi1EEvPKT_PKfPS0_iif
_Z10rms_kernelIfLi2EEvPKT_PKfPS0_iif
_Z10rms_kernelIfLi4EEvPKT_PKfPS0_iif
_Z10rms_kernelIfLi8EEvPKT_PKfPS0_iif
_Z11atax_kernelI13__nv_bfloat16Li1024ELi1EEvPKT_S3_Pfiii
_Z11atax_kernelI13__nv_bfloat16Li128ELi1EEvPKT_S3_Pfiii
_Z11atax_kernelI13__nv_bfloat16Li128ELi4EEvPKT_S3_Pfiii
_Z11atax_kernelI13__nv_bfloat16Li256ELi1EEvPKT_S3_Pfiii
_Z11atax_kernelI13__nv_bfloat16Li256ELi2EEvPKT_S3_Pfiii
_Z11atax_kernelI13__nv_bfloat16Li256ELi4EEvPKT_S3_Pfiii
_Z11atax_kernelI13__nv_bfloat16Li32ELi1EEvPKT_S3_Pfiii
_Z11atax_kernelI13__nv_bfloat16Li512ELi1EEvPKT_S3_Pfiii
_Z11atax_kernelI13__nv_bfloat16Li512ELi2EEvPKT_S3_Pfiii
_Z11atax_kernelI13__nv_bfloat16Li64ELi1EEvPKT_S3_Pfiii
_Z11atax_kernelIfLi1024ELi1EEvPKT_S2_Pfiii
_Z11atax_kernelIfLi128ELi1EEvPKT_S2_Pfiii
_Z11atax_kernelIfLi128ELi4EEvPKT_S2_Pfiii
_Z11atax_kernelIfLi256ELi1EEvPKT_S2_Pfiii
_Z11atax_kernelIfLi256ELi2EEvPKT_S2_Pfiii
_Z11atax_kernelIfLi256ELi4EEvPKT_S2_Pfiii
_Z11atax_kernelIfLi32ELi1EEvPKT_S2_Pfiii
_Z11atax_kernelIfLi512ELi1EEvPKT_S2_Pfiii
_Z11atax_kernelIfLi512ELi2EEvPKT_S2_Pfiii
_Z11atax_kernelIfLi64ELi1EEvPKT_S2_Pfiii
_Z11bicg_kernelI13__nv_bfloat16Li1024ELi1EEvPKT_S3_S3_PS1_Pfiii
_Z11bicg_kernelI13__nv_bfloat16Li128ELi1EEvPKT_S3_S3_PS1_Pfiii
_Z11bicg_kernelI13__nv_bfloat16Li128ELi4EEvPKT_S3_S3_PS1_Pfiii
_Z11bicg_kernelI13__nv_bfloat16Li256ELi1EEvPKT_S3_S3_PS1_Pfiii
_Z11bicg_kernelI13__nv_bfloat16Li256ELi2EEvPKT_S3_S3_PS1_Pfiii
_Z11bicg_kernelI13__nv_bfloat16Li256ELi4EEvPKT_S3_S3_PS1_Pfiii
_Z11bicg_kernelI13__nv_bfloat16Li32ELi1EEvPKT_S3_S3_PS1_Pfiii
_Z11bicg_kernelI13__nv_bfloat16Li512ELi1EEvPKT_S3_S3_PS1_Pfiii
_Z11bicg_kernelI13__nv_bfloat16Li512ELi2EEvPKT_S3_S3_PS1_Pfiii
_Z11bicg_kernelI13__nv_bfloat16Li64ELi1EEvPKT_S3_S3_PS1_Pfiii
_Z11bicg_kernelIfLi1024ELi1EEvPKT_S2_S2_PS0_Pfiii
_Z11bicg_kernelIfLi128ELi1EEvPKT_S2_S2_PS0_Pfiii
_Z11bicg_kernelIfLi128ELi4EEvPKT_S2_S2_PS0_Pfiii
_Z11bicg_kernelIfLi256ELi1EEvPKT_S2_S2_PS0_Pfiii
_Z11bicg_kernelIfLi256ELi2EEvPKT_S2_S2_PS0_Pfiii
_Z11bicg_kernelIfLi256ELi4EEvPKT_S2_S2_PS0_Pfiii
_Z11bicg_kernelIfLi32ELi1EEvPKT_S2_S2_PS0_Pfiii
_Z11bicg_kernelIfLi512ELi1EEvPKT_S2_S2_PS0_Pfiii
_Z11bicg_kernelIfLi512ELi2EEvPKT_S2_S2_PS0_Pfiii
_Z11bicg_kernelIfLi64ELi1EEvPKT_S2_S2_PS0_Pfiii
_Z11gemm_kernelI13__nv_bfloat16S0_Li128ELi128ELi16ELi8ELi8EEvPKT_S3_PT0_iii
_Z11gemm_kernelI13__nv_bfloat16S0_Li128ELi64ELi16ELi8ELi4EEvPKT_S3_PT0_iii
_Z11gemm_kernelI13__nv_bfloat16S0_Li16ELi16ELi64ELi1ELi1EEvPKT_S3_PT0_iii
_Z11gemm_kernelI13__nv_bfloat16S0_Li16ELi32ELi64ELi1ELi2EEvPKT_S3_PT0_iii
_Z11gemm_kernelI13__nv_bfloat16S0_Li16ELi64ELi32ELi1ELi4EEvPKT_S3_PT0_iii
_Z11gemm_kernelI13__nv_bfloat16S0_Li32ELi64ELi32ELi2ELi4EEvPKT_S3_PT0_iii
_Z11gemm_kernelI13__nv_bfloat16S0_Li64ELi128ELi16ELi4ELi8EEvPKT_S3_PT0_iii
_Z11gemm_kernelI13__nv_bfloat16S0_Li64ELi64ELi16ELi4ELi4EEvPKT_S3_PT0_iii
_Z11gemm_kernelI13__nv_bfloat16fLi128ELi128ELi16ELi8ELi8EEvPKT_S3_PT0_iii
_Z11gemm_kernelI13__nv_bfloat16fLi128ELi64ELi16ELi8ELi4EEvPKT_S3_PT0_iii
_Z11gemm_kernelI13__nv_bfloat16fLi16ELi16ELi64ELi1ELi1EEvPKT_S3_PT0_iii
_Z11gemm_kernelI13__nv_bfloat16fLi16ELi32ELi64ELi1ELi2EEvPKT_S3_PT0_iii
_Z11gemm_kernelI13__nv_bfloat16fLi16ELi64ELi32ELi1ELi4EEvPKT_S3_PT0_iii
_Z11gemm_kernelI13__nv_bfloat16fLi32ELi64ELi32ELi2ELi4EEvPKT_S3_PT0_iii
_Z11gemm_kernelI13__nv_bfloat16fLi64ELi128ELi16ELi4ELi8EEvPKT_S3_PT0_iii
_Z11gemm_kernelI13__nv_bfloat16fLi64ELi64ELi16ELi4ELi4EEvPKT_S3_PT0_iii
_Z11gemm_kernelIffLi128ELi128ELi16ELi8ELi8EEvPKT_S2_PT0_iii
_Z11gemm_kernelIffLi128ELi64ELi16ELi8ELi4EEvPKT_S2_PT0_iii
_Z11gemm_kernelIffLi16ELi16ELi64ELi1ELi1EEvPKT_S2_PT0_iii
_Z11gemm_kernelIffLi16ELi32ELi64ELi1ELi2EEvPKT_S2_PT0_iii
_Z11gemm_kernelIffLi16ELi64ELi32ELi1ELi4EEvPKT_S2_PT0_iii
_Z11gemm_kernelIffLi32ELi64ELi32ELi2ELi4EEvPKT_S2_PT0_iii
_Z11gemm_kernelIffLi64ELi128ELi16ELi4ELi8EEvPKT_S2_PT0_iii
_Z11gemm_kernelIffLi64ELi64ELi16ELi4ELi4EEvPKT_S2_PT0_iii
_Z11gemv_kernelI13__nv_bfloat16S0_Li4EEvPKT_S3_PT0_iiiii
_Z11gemv_kernelI13__nv_bfloat16fLi4EEvPKT_S3_PT0_iiiii
_Z11gemv_kernelIffLi4EEvPKT_S2_PT0_iiiii
_Z12flash_kernelI13__nv_bfloat16Li16ELi32ELi128EEvPKT_S3_S3_PS1_iiiif
_Z12flash_kernelI13__nv_bfloat16Li16ELi64ELi128EEvPKT_S3_S3_PS1_iiiif
_Z12flash_kernelI13__nv_bfloat16Li32ELi32ELi256EEvPKT_S3_S3_PS1_iiiif
_Z12flash_kernelI13__nv_bfloat16Li32ELi64ELi256EEvPKT_S3_S3_PS1_iiiif
_Z12flash_kernelI13__nv_bfloat16Li64ELi64ELi256EEvPKT_S3_S3_PS1_iiiif
_Z12flash_kernelIfLi16ELi32ELi128EEvPKT_S2_S2_PS0_iiiif
_Z12flash_kernelIfLi16ELi64ELi128EEvPKT_S2_S2_PS0_iiiif
_Z12flash_kernelIfLi32ELi32ELi256EEvPKT_S2_S2_PS0_iiiif
_Z12flash_kernelIfLi32ELi64ELi256EEvPKT_S2_S2_PS0_iiiif
_Z12flash_kernelIfLi64ELi64ELi256EEvPKT_S2_S2_PS0_iiiif
_Z12gated_kernelI13__nv_bfloat16Li128ELi64ELi16ELi8ELi4EEvPKT_S3_S3_PS1_iiii
_Z12gated_kernelI13__nv_bfloat16Li16ELi16ELi64ELi1ELi1EEvPKT_S3_S3_PS1_iiii
_Z12gated_kernelI13__nv_bfloat16Li16ELi32ELi64ELi1ELi2EEvPKT_S3_S3_PS1_iiii
_Z12gated_kernelI13__nv_bfloat16Li16ELi64ELi32ELi1ELi4EEvPKT_S3_S3_PS1_iiii
_Z12gated_kernelI13__nv_bfloat16Li32ELi64ELi32ELi2ELi4EEvPKT_S3_S3_PS1_iiii
_Z12gated_kernelI13__nv_bfloat16Li64ELi128ELi16ELi4ELi8EEvPKT_S3_S3_PS1_iiii
_Z12gated_kernelI13__nv_bfloat16Li64ELi64ELi16ELi4ELi4EEvPKT_S3_S3_PS1_iiii
_Z12gated_kernelIfLi128ELi64ELi16ELi8ELi4EEvPKT_S2_S2_PS0_iiii
_Z12gated_kernelIfLi16ELi16ELi64ELi1ELi1EEvPKT_S2_S2_PS0_iiii
_Z12gated_kernelIfLi16ELi32ELi64ELi1ELi2EEvPKT_S2_S2_PS0_iiii
_Z12gated_kernelIfLi16ELi64ELi32ELi1ELi4EEvPKT_S2_S2_PS0_iiii
_Z12gated_kernelIfLi32ELi64ELi32ELi2ELi4EEvPKT_S2_S2_PS0_iiii
_Z12gated_kernelIfLi64ELi128ELi16ELi4ELi8EEvPKT_S2_S2_PS0_iiii
_Z12gated_kernelIfLi64ELi64ELi16ELi4ELi4EEvPKT_S2_S2_PS0_iiii
_Z12saxpy_kernelI13__nv_bfloat16Li1024ELi1EEvPKT_S3_PS1_xx
_Z12saxpy_kernelI13__nv_bfloat16Li1024ELi4EEvPKT_S3_PS1_xx
_Z12saxpy_kernelI13__nv_bfloat16Li128ELi1EEvPKT_S3_PS1_xx
_Z12saxpy_kernelI13__nv_bfloat16Li128ELi2EEvPKT_S3_PS1_xx
_Z12saxpy_kernelI13__nv_bfloat16Li128ELi4EEvPKT_S3_PS1_xx
_Z12saxpy_kernelI13__nv_bfloat16Li256ELi1EEvPKT_S3_PS1_xx
_Z12saxpy_kernelI13__nv_bfloat16Li256ELi2EEvPKT_S3_PS1_xx
_Z12saxpy_kernelI13__nv_bfloat16Li256ELi4EEvPKT_S3_PS1_xx
_Z12saxpy_kernelI13__nv_bfloat16Li512ELi1EEvPKT_S3_PS1_xx
_Z12saxpy_kernelI13__nv_bfloat16Li512ELi2EEvPKT_S3_PS1_xx
_Z12saxpy_kernelIfLi1024ELi1EEvPKT_S2_PS0_xx
_Z12saxpy_kernelIfLi1024ELi4EEvPKT_S2_PS0_xx
_Z12saxpy_kernelIfLi128ELi1EEvPKT_S2_PS0_xx
_Z12saxpy_kernelIfLi128ELi2EEvPKT_S2_PS0_xx
_Z12saxpy_kernelIfLi128ELi4EEvPKT_S2_PS0_xx
_Z12saxpy_kernelIfLi256ELi1EEvPKT_S2_PS0_xx
_Z12saxpy_kernelIfLi256ELi2EEvPKT_S2_PS0_xx
_Z12saxpy_kernelIfLi256ELi4EEvPKT_S2_PS0_xx
_Z12saxpy_kernelIfLi512ELi1EEvPKT_S2_PS0_xx
_Z12saxpy_kernelIfLi512ELi2EEvPKT_S2_PS0_xx
_Z12wgmma_kernelI13__nv_bfloat16Li128ELi4EEv14CUtensorMap_stS1_PT_iii
_Z12wgmma_kernelI13__nv_bfloat16Li256ELi4EEv14CUtensorMap_stS1_PT_iii
_Z12wgmma_kernelIfLi128ELi4EEv14CUtensorMap_stS0_PT_iii
_Z12wgmma_kernelIfLi256ELi4EEv14CUtensorMap_stS0_PT_iii
_Z13colsum_kernelI13__nv_bfloat16EvPKfPT_ii
_Z13colsum_kernelIfEvPKfPT_ii
_Z13jacobi_kernelI13__nv_bfloat16Li32ELi16ELi16EEvPKT_PS1_iiiff
_Z13jacobi_kernelI13__nv_bfloat16Li32ELi1ELi32EEvPKT_PS1_iiiff
_Z13jacobi_kernelI13__nv_bfloat16Li32ELi2ELi32EEvPKT_PS1_iiiff
_Z13jacobi_kernelI13__nv_bfloat16Li32ELi32ELi16EEvPKT_PS1_iiiff
_Z13jacobi_kernelI13__nv_bfloat16Li32ELi4ELi16EEvPKT_PS1_iiiff
_Z13jacobi_kernelI13__nv_bfloat16Li32ELi8ELi16EEvPKT_PS1_iiiff
_Z13jacobi_kernelI13__nv_bfloat16Li32ELi8ELi64EEvPKT_PS1_iiiff
_Z13jacobi_kernelI13__nv_bfloat16Li64ELi16ELi16EEvPKT_PS1_iiiff
_Z13jacobi_kernelI13__nv_bfloat16Li64ELi4ELi16EEvPKT_PS1_iiiff
_Z13jacobi_kernelI13__nv_bfloat16Li64ELi8ELi16EEvPKT_PS1_iiiff
_Z13jacobi_kernelIfLi32ELi16ELi16EEvPKT_PS0_iiiff
_Z13jacobi_kernelIfLi32ELi1ELi32EEvPKT_PS0_iiiff
_Z13jacobi_kernelIfLi32ELi2ELi32EEvPKT_PS0_iiiff
_Z13jacobi_kernelIfLi32ELi32ELi16EEvPKT_PS0_iiiff
_Z13jacobi_kernelIfLi32ELi4ELi16EEvPKT_PS0_iiiff
_Z13jacobi_kernelIfLi32ELi8ELi16EEvPKT_PS0_iiiff
_Z13jacobi_kernelIfLi32ELi8ELi64EEvPKT_PS0_iiiff
_Z13jacobi_kernelIfLi64ELi16ELi16EEvPKT_PS0_iiiff
_Z13jacobi_kernelIfLi64ELi4ELi16EEvPKT_PS0_iiiff
_Z13jacobi_kernelIfLi64ELi8ELi16EEvPKT_PS0_iiiff
_Z13matvec_kernelI13__nv_bfloat16Li16ELi1EEvPKT_S3_PS1_iii
_Z13matvec_kernelI13__nv_bfloat16Li1ELi1EEvPKT_S3_PS1_iii
_Z13matvec_kernelI13__nv_bfloat16Li1ELi4EEvPKT_S3_PS1_iii
_Z13matvec_kernelI13__nv_bfloat16Li1ELi8EEvPKT_S3_PS1_iii
_Z13matvec_kernelI13__nv_bfloat16Li2ELi1EEvPKT_S3_PS1_iii
_Z13matvec_kernelI13__nv_bfloat16Li2ELi8EEvPKT_S3_PS1_iii
_Z13matvec_kernelI13__nv_bfloat16Li32ELi1EEvPKT_S3_PS1_iii
_Z13matvec_kernelI13__nv_bfloat16Li4ELi1EEvPKT_S3_PS1_iii
_Z13matvec_kernelI13__nv_bfloat16Li4ELi8EEvPKT_S3_PS1_iii
_Z13matvec_kernelI13__nv_bfloat16Li8ELi1EEvPKT_S3_PS1_iii
_Z13matvec_kernelIfLi16ELi1EEvPKT_S2_PS0_iii
_Z13matvec_kernelIfLi1ELi1EEvPKT_S2_PS0_iii
_Z13matvec_kernelIfLi1ELi4EEvPKT_S2_PS0_iii
_Z13matvec_kernelIfLi1ELi8EEvPKT_S2_PS0_iii
_Z13matvec_kernelIfLi2ELi1EEvPKT_S2_PS0_iii
_Z13matvec_kernelIfLi2ELi8EEvPKT_S2_PS0_iii
_Z13matvec_kernelIfLi32ELi1EEvPKT_S2_PS0_iii
_Z13matvec_kernelIfLi4ELi1EEvPKT_S2_PS0_iii
_Z13matvec_kernelIfLi4ELi8EEvPKT_S2_PS0_iii
_Z13matvec_kernelIfLi8ELi1EEvPKT_S2_PS0_iii
_Z13stream_kernelI13__nv_bfloat16Li16ELi16ELi1ELi1EEvPKT_S3_S3_PS1_iiii
_Z13stream_kernelI13__nv_bfloat16Li32ELi32ELi2ELi2EEvPKT_S3_S3_PS1_iiii
_Z13stream_kernelI13__nv_bfloat16Li4ELi4ELi1ELi1EEvPKT_S3_S3_PS1_iiii
_Z13stream_kernelI13__nv_bfloat16Li8ELi8ELi1ELi1EEvPKT_S3_S3_PS1_iiii
_Z13stream_kernelIfLi16ELi16ELi1ELi1EEvPKT_S2_S2_PS0_iiii
_Z13stream_kernelIfLi32ELi32ELi2ELi2EEvPKT_S2_S2_PS0_iiii
_Z13stream_kernelIfLi4ELi4ELi1ELi1EEvPKT_S2_S2_PS0_iiii
_Z13stream_kernelIfLi8ELi8ELi1ELi1EEvPKT_S2_S2_PS0_iiii
_Z14blocked_kernelI13__nv_bfloat16Li16ELi128EEvPKT_S3_S3_PS1_iiiif
_Z14blocked_kernelI13__nv_bfloat16Li32ELi256EEvPKT_S3_S3_PS1_iiiif
_Z14blocked_kernelI13__nv_bfloat16Li64ELi256EEvPKT_S3_S3_PS1_iiiif
_Z14blocked_kernelI13__nv_bfloat16Li8ELi128EEvPKT_S3_S3_PS1_iiiif
_Z14blocked_kernelIfLi16ELi128EEvPKT_S2_S2_PS0_iiiif
_Z14blocked_kernelIfLi32ELi256EEvPKT_S2_S2_PS0_iiiif
_Z14blocked_kernelIfLi64ELi256EEvPKT_S2_S2_PS0_iiiif
_Z14blocked_kernelIfLi8ELi128EEvPKT_S2_S2_PS0_iiiif
_Z14rms_vec_kernelI13__nv_bfloat16Li128EEvPKT_PKfPS1_if
_Z14rms_vec_kernelI13__nv_bfloat16Li256EEvPKT_PKfPS1_if
_Z14rms_vec_kernelI13__nv_bfloat16Li64EEvPKT_PKfPS1_if
_Z14rms_vec_kernelIfLi128EEvPKT_PKfPS0_if
_Z14rms_vec_kernelIfLi256EEvPKT_PKfPS0_if
_Z14rms_vec_kernelIfLi64EEvPKT_PKfPS0_if
_Z14stencil_kernelI13__nv_bfloat16Li128ELi1ELi64EEvPKT_PS1_iiff
_Z14stencil_kernelI13__nv_bfloat16Li128ELi2ELi16EEvPKT_PS1_iiff
_Z14stencil_kernelI13__nv_bfloat16Li128ELi4ELi16EEvPKT_PS1_iiff
_Z14stencil_kernelI13__nv_bfloat16Li128ELi8ELi8EEvPKT_PS1_iiff
_Z14stencil_kernelI13__nv_bfloat16Li256ELi1ELi32EEvPKT_PS1_iiff
_Z14stencil_kernelI13__nv_bfloat16Li256ELi2ELi16EEvPKT_PS1_iiff
_Z14stencil_kernelI13__nv_bfloat16Li32ELi1ELi16EEvPKT_PS1_iiff
_Z14stencil_kernelI13__nv_bfloat16Li32ELi32ELi4EEvPKT_PS1_iiff
_Z14stencil_kernelI13__nv_bfloat16Li32ELi4ELi16EEvPKT_PS1_iiff
_Z14stencil_kernelI13__nv_bfloat16Li512ELi1ELi8EEvPKT_PS1_iiff
_Z14stencil_kernelI13__nv_bfloat16Li64ELi2ELi32EEvPKT_PS1_iiff
_Z14stencil_kernelIfLi128ELi1ELi64EEvPKT_PS0_iiff
_Z14stencil_kernelIfLi128ELi2ELi16EEvPKT_PS0_iiff
_Z14stencil_kernelIfLi128ELi4ELi16EEvPKT_PS0_iiff
_Z14stencil_kernelIfLi128ELi8ELi8EEvPKT_PS0_iiff
_Z14stencil_kernelIfLi256ELi1ELi32EEvPKT_PS0_iiff
_Z14stencil_kernelIfLi256ELi2ELi16EEvPKT_PS0_iiff
_Z14stencil_kernelIfLi32ELi1ELi16EEvPKT_PS0_iiff
_Z14stencil_kernelIfLi32ELi32ELi4EEvPKT_PS0_iiff
_Z14stencil_kernelIfLi32ELi4ELi16EEvPKT_PS0_iiff
_Z14stencil_kernelIfLi512ELi1ELi8EEvPKT_PS0_iiff
_Z14stencil_kernelIfLi64ELi2ELi32EEvPKT_PS0_iiff
_Z16flash_mma_kernelILi16ELi32ELi2ELi2EEvPK13__nv_bfloat16S2_S2_PS0_iiiif
_Z16flash_mma_kernelILi16ELi64ELi2ELi2EEvPK13__nv_bfloat16S2_S2_PS0_iiiif
_Z16flash_mma_kernelILi16ELi64ELi4ELi4EEvPK13__nv_bfloat16S2_S2_PS0_iiiif
_Z16flash_mma_kernelILi32ELi64ELi4ELi2EEvPK13__nv_bfloat16S2_S2_PS0_iiiif
_Z16flash_mma_kernelILi32ELi64ELi8ELi4EEvPK13__nv_bfloat16S2_S2_PS0_iiiif
_Z16flash_mma_kernelILi64ELi32ELi4ELi1EEvPK13__nv_bfloat16S2_S2_PS0_iiiif
_Z16flash_mma_kernelILi64ELi64ELi4ELi1EEvPK13__nv_bfloat16S2_S2_PS0_iiiif
_Z16flash_mma_kernelILi64ELi64ELi8ELi2EEvPK13__nv_bfloat16S2_S2_PS0_iiiif
_Z17blocked_tc_kernelI13__nv_bfloat16Li16ELi2EEvPKT_S3_S3_PS1_iiiif
_Z17blocked_tc_kernelI13__nv_bfloat16Li16ELi4EEvPKT_S3_S3_PS1_iiiif
_Z17blocked_tc_kernelI13__nv_bfloat16Li32ELi4EEvPKT_S3_S3_PS1_iiiif
_Z17blocked_tc_kernelI13__nv_bfloat16Li32ELi8EEvPKT_S3_S3_PS1_iiiif
_Z17blocked_tc_kernelI13__nv_bfloat16Li64ELi4EEvPKT_S3_S3_PS1_iiiif
_Z17blocked_tc_kernelI13__nv_bfloat16Li64ELi8EEvPKT_S3_S3_PS1_iiiif
_Z17blocked_tc_kernelIfLi16ELi2EEvPKT_S2_S2_PS0_iiiif
_Z17blocked_tc_kernelIfLi16ELi4EEvPKT_S2_S2_PS0_iiiif
_Z17blocked_tc_kernelIfLi32ELi4EEvPKT_S2_S2_PS0_iiiif
_Z17blocked_tc_kernelIfLi32ELi8EEvPKT_S2_S2_PS0_iiiif
_Z17blocked_tc_kernelIfLi64ELi4EEvPKT_S2_S2_PS0_iiiif
_Z17blocked_tc_kernelIfLi64ELi8EEvPKT_S2_S2_PS0_iiiif
_Z17flash_tf32_kernelILi16ELi32ELi2ELi2EEvPKfS1_S1_Pfiiiif
_Z17flash_tf32_kernelILi16ELi32ELi4ELi4EEvPKfS1_S1_Pfiiiif
_Z17flash_tf32_kernelILi16ELi64ELi2ELi2EEvPKfS1_S1_Pfiiiif
_Z17flash_tf32_kernelILi16ELi64ELi4ELi4EEvPKfS1_S1_Pfiiiif
_Z17flash_tf32_kernelILi32ELi32ELi4ELi2EEvPKfS1_S1_Pfiiiif
_Z17flash_tf32_kernelILi32ELi32ELi8ELi4EEvPKfS1_S1_Pfiiiif
_Z17flash_tf32_kernelILi32ELi64ELi8ELi4EEvPKfS1_S1_Pfiiiif
_Z17flash_tf32_kernelILi64ELi32ELi4ELi1EEvPKfS1_S1_Pfiiiif
_Z18gated_wgmma_kernelILi128ELi3EEv14CUtensorMap_stS0_S0_P13__nv_bfloat16iiii
_Z18gated_wgmma_kernelILi128ELi4EEv14CUtensorMap_stS0_S0_P13__nv_bfloat16iiii
_Z18gated_wgmma_kernelILi64ELi3EEv14CUtensorMap_stS0_S0_P13__nv_bfloat16iiii
_Z18gated_wgmma_kernelILi64ELi4EEv14CUtensorMap_stS0_S0_P13__nv_bfloat16iiii
_Z18jacobi_ring_kernelI13__nv_bfloat16Li128ELi16ELi16ELi4EEv14CUtensorMap_stPT_iiiff
_Z18jacobi_ring_kernelI13__nv_bfloat16Li128ELi8ELi16ELi4EEv14CUtensorMap_stPT_iiiff
_Z18jacobi_ring_kernelI13__nv_bfloat16Li128ELi8ELi32ELi6EEv14CUtensorMap_stPT_iiiff
_Z18jacobi_ring_kernelI13__nv_bfloat16Li64ELi16ELi16ELi4EEv14CUtensorMap_stPT_iiiff
_Z18jacobi_ring_kernelI13__nv_bfloat16Li64ELi8ELi16ELi4EEv14CUtensorMap_stPT_iiiff
_Z18jacobi_ring_kernelI13__nv_bfloat16Li64ELi8ELi32ELi8EEv14CUtensorMap_stPT_iiiff
_Z18jacobi_ring_kernelIfLi128ELi16ELi16ELi4EEv14CUtensorMap_stPT_iiiff
_Z18jacobi_ring_kernelIfLi128ELi8ELi16ELi4EEv14CUtensorMap_stPT_iiiff
_Z18jacobi_ring_kernelIfLi128ELi8ELi32ELi6EEv14CUtensorMap_stPT_iiiff
_Z18jacobi_ring_kernelIfLi64ELi16ELi16ELi4EEv14CUtensorMap_stPT_iiiff
_Z18jacobi_ring_kernelIfLi64ELi8ELi16ELi4EEv14CUtensorMap_stPT_iiiff
_Z18jacobi_ring_kernelIfLi64ELi8ELi32ELi8EEv14CUtensorMap_stPT_iiiff
_Z18rms_cluster_kernelI13__nv_bfloat16Li2ELi256EEvPKT_PKfPS1_if
_Z18rms_cluster_kernelI13__nv_bfloat16Li4ELi128EEvPKT_PKfPS1_if
_Z18rms_cluster_kernelI13__nv_bfloat16Li4ELi256EEvPKT_PKfPS1_if
_Z18rms_cluster_kernelI13__nv_bfloat16Li8ELi128EEvPKT_PKfPS1_if
_Z18rms_cluster_kernelI13__nv_bfloat16Li8ELi256EEvPKT_PKfPS1_if
_Z18rms_cluster_kernelIfLi2ELi256EEvPKT_PKfPS0_if
_Z18rms_cluster_kernelIfLi4ELi128EEvPKT_PKfPS0_if
_Z18rms_cluster_kernelIfLi4ELi256EEvPKT_PKfPS0_if
_Z18rms_cluster_kernelIfLi8ELi128EEvPKT_PKfPS0_if
_Z18rms_cluster_kernelIfLi8ELi256EEvPKT_PKfPS0_if
_Z18stream_gemv_kernelI13__nv_bfloat16Li1ELi128ELi16EEvPKT_S3_S3_PS1_iiiiii
_Z18stream_gemv_kernelI13__nv_bfloat16Li1ELi64ELi16EEvPKT_S3_S3_PS1_iiiiii
_Z18stream_gemv_kernelI13__nv_bfloat16Li4ELi128ELi16EEvPKT_S3_S3_PS1_iiiiii
_Z18stream_gemv_kernelI13__nv_bfloat16Li4ELi64ELi16EEvPKT_S3_S3_PS1_iiiiii
_Z18stream_gemv_kernelI13__nv_bfloat16Li8ELi128ELi8EEvPKT_S3_S3_PS1_iiiiii
_Z18stream_gemv_kernelI13__nv_bfloat16Li8ELi64ELi8EEvPKT_S3_S3_PS1_iiiiii
_Z18stream_gemv_kernelIfLi1ELi128ELi16EEvPKT_S2_S2_PS0_iiiiii
_Z18stream_gemv_kernelIfLi1ELi64ELi16EEvPKT_S2_S2_PS0_iiiiii
_Z18stream_gemv_kernelIfLi4ELi128ELi16EEvPKT_S2_S2_PS0_iiiiii
_Z18stream_gemv_kernelIfLi4ELi64ELi16EEvPKT_S2_S2_PS0_iiiiii
_Z18stream_gemv_kernelIfLi8ELi128ELi8EEvPKT_S2_S2_PS0_iiiiii
_Z18stream_gemv_kernelIfLi8ELi64ELi8EEvPKT_S2_S2_PS0_iiiiii
_Z19stencil_ring_kernelI13__nv_bfloat16Li128ELi16ELi126ELi6EEv14CUtensorMap_stPT_iiff
_Z19stencil_ring_kernelI13__nv_bfloat16Li128ELi8ELi62ELi6EEv14CUtensorMap_stPT_iiff
_Z19stencil_ring_kernelI13__nv_bfloat16Li64ELi16ELi126ELi6EEv14CUtensorMap_stPT_iiff
_Z19stencil_ring_kernelI13__nv_bfloat16Li64ELi8ELi62ELi4EEv14CUtensorMap_stPT_iiff
_Z19stencil_ring_kernelIfLi128ELi16ELi126ELi6EEv14CUtensorMap_stPT_iiff
_Z19stencil_ring_kernelIfLi128ELi8ELi62ELi6EEv14CUtensorMap_stPT_iiff
_Z19stencil_ring_kernelIfLi64ELi16ELi126ELi6EEv14CUtensorMap_stPT_iiff
_Z19stencil_ring_kernelIfLi64ELi8ELi62ELi4EEv14CUtensorMap_stPT_iiff
_Z20splitk_reduce_kernelI13__nv_bfloat16EvPKfPT_mi
_Z20splitk_reduce_kernelIfEvPKfPT_mi
"""
