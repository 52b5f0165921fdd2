"""Plain-PyTorch oracles for the four kernels of the serving path.

The counterparts of the reference's jnp oracles (`repro.kernels.ref`):
the ground truth the kernels' plain versions and CUDA kernels are held
against.  ``attention_ref`` keeps the oracle's bottom-right-aligned
causal mask, which agrees with the kernels' top-left mask only when
``sq == skv`` — the only case serving calls.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["matmul_ref", "attention_ref", "mlp_matmul_ref", "rms_norm_ref",
           "MLP_ACTS"]

MLP_ACTS = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
}


def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a.float(), b.float()).to(a.dtype)


def mlp_matmul_ref(x: torch.Tensor, w_gate: torch.Tensor,
                   w_up: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """Gated-MLP up-projection oracle: ``act(x @ w_gate) * (x @ w_up)``
    with f32 matmuls and activation, cast back to x's type."""
    gate = torch.matmul(x.float(), w_gate.float())
    up = torch.matmul(x.float(), w_up.float())
    return (MLP_ACTS[act](gate) * up).to(x.dtype)


def rms_norm_ref(x: torch.Tensor, w: torch.Tensor,
                 eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm oracle over the last axis in f32."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, scale: float | None = None
                  ) -> torch.Tensor:
    """Multi-head attention oracle.  q, k, v: (B, H, S, D)."""
    s, d = q.shape[2], q.shape[3]
    skv = k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        mask = torch.ones((s, skv), dtype=torch.bool,
                          device=q.device).tril(skv - s)
        logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
