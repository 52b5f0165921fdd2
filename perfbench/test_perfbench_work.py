"""The yardstick's arithmetic against counts made by hand."""
import pytest
import torch

from perfbench import work

# one layer, small enough to count by hand
DENSE = {"family": "dense", "n_layers": 1, "d_model": 8, "n_heads": 2,
         "n_kv": 1, "d_ff": 16, "vocab": 10, "qkv_bias": True,
         "dtype": "bfloat16"}
MOE = {"family": "moe", "n_layers": 1, "d_model": 8, "n_heads": 2,
       "n_kv": 2, "d_ff_expert": 3, "n_experts": 4, "top_k": 2,
       "n_shared": 1, "vocab": 10, "qkv_bias": True, "dtype": "bfloat16"}


def test_dense_layer_by_hand():
    # a token: q, k, v 2*8*(2+1+1)*4 = 256; out 2*(2*4)*8 = 128;
    # gate, up, down 3*2*8*16 = 768 -> 1152
    # 3 tokens: 3456; causal core 4*2*4 * (1+2+3) = 192; head at the
    # last position 2*8*10 = 160
    assert work.prefill_flops(DENSE, 1, 3) == 3456 + 192 + 160
    assert work.prefill_flops(DENSE, 2, 3) == 2 * (3456 + 192 + 160)
    # a step over 5 slots: 1152 + core 4*2*4*5 = 160 + head 160
    assert work.decode_flops(DENSE, 2, 5) == 2 * (1152 + 160 + 160)
    # bytes: q,k,v 8*4*4 + out 2*4*8 + bias 4*4 + mlp 3*8*16 = 592 bf16
    # values (1184 B) + two f32 gains (64 B); head 8*10*2 = 160 B;
    # cache 2 sequences * 5 slots * (k, v) * 1 head * 4 * 2 B = 160 B
    assert work.decode_bytes(DENSE, 2, 5) == 1184 + 64 + 160 + 160


def test_moe_layer_by_hand():
    # a token: q, k, v 2*8*(2+2+2)*4 = 384; out 128; router 2*8*4 = 64;
    # two routed experts 2*3*2*8*3 = 288; one shared 3*2*8*3 = 144
    per = 384 + 128 + 64 + 288 + 144
    assert work.prefill_flops(MOE, 1, 1) == per + 4 * 2 * 4 * 1 + 160
    # every expert's weights are read by a step: 3*8*3*(4+1) = 360 bf16
    # values; router 8*4 f32
    w = (8 * 6 * 4 + 2 * 4 * 8 + 6 * 4 + 360) * 2 + 8 * 4 * 4 + 64
    assert work.decode_bytes(MOE, 1, 1) == w + 160 + 1 * 1 * 2 * 2 * 4 * 2


@pytest.mark.parametrize("name,args,kw,want", [
    ("matmul", (torch.empty(4, 8, dtype=torch.bfloat16),
                torch.empty(8, 16, dtype=torch.bfloat16)), {},
     (2 * 4 * 8 * 16, 2 * (32 + 128 + 64), "bfloat16")),
    ("mlp_matmul", (torch.empty(4, 8, dtype=torch.bfloat16),
                    torch.empty(8, 16, dtype=torch.bfloat16),
                    torch.empty(8, 16, dtype=torch.bfloat16), "silu"), {},
     (4 * 4 * 8 * 16, 2 * (32 + 2 * 128 + 64), "bfloat16")),
    ("rms_norm", (torch.empty(4, 8, dtype=torch.bfloat16),
                  torch.empty(8, dtype=torch.float32)), {"eps": 1e-6},
     (4 * 32, 2 * 2 * 32 + 4 * 8, "bfloat16")),
    ("flash_attention", tuple(torch.empty(1, 2, 3, 4, dtype=torch.bfloat16)
                              for _ in range(3)) + (True,), {},
     (4 * 2 * 4 * 6, 2 * 2 * 4 * 12, "bfloat16")),
    ("atax", (), {}, None),
])
def test_op_work(name, args, kw, want):
    assert work.op_work(name, args, kw) == want


def test_least_time_takes_the_slower_bound():
    assert work.least_s(989e12, 0.0, "bfloat16") == pytest.approx(1.0)
    assert work.least_s(0.0, 3.35e12, "bfloat16") == pytest.approx(1.0)
    assert work.least_s(989e12, 6.7e12, "bfloat16") == pytest.approx(2.0)
