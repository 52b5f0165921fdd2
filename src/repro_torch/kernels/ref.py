"""Plain-PyTorch oracles for the port's kernels.

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

__all__ = ["matmul_ref", "matvec_ref", "atax_ref", "bicg_ref",
           "jacobi3d_ref", "attention_ref", "mlp_matmul_ref", "rms_norm_ref",
           "MLP_ACTS"]

MLP_ACTS = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
}


def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a.float(), b.float()).to(a.dtype)


def matvec_ref(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """MatVec2D (paper Table IV): y = A x.  x, y are (N, 1)/(M, 1)."""
    return torch.matmul(a.float(), x.float()).to(a.dtype)


def atax_ref(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """atax (paper Table IV): y = A^T (A x), t = A x kept in f32."""
    t = torch.matmul(a.float(), x.float())
    return torch.matmul(a.float().T, t).to(a.dtype)


def bicg_ref(a: torch.Tensor, p: torch.Tensor, r: torch.Tensor):
    """BiCG subkernel (paper Table IV): q = A p, s = A^T r."""
    q = torch.matmul(a.float(), p.float())
    s = torch.matmul(a.float().T, r.float())
    return q.to(a.dtype), s.to(a.dtype)


def jacobi3d_ref(u: torch.Tensor, c0: float = 0.5, c1: float = 1.0 / 12.0
                 ) -> torch.Tensor:
    """ex14FJ-style 7-point 3-D Jacobi sweep, Dirichlet boundaries:
    c0*u + c1*(sum of 6 face neighbours) on the interior in f32,
    boundary cells pass through unchanged."""
    f = u.float()
    interior = (
        c0 * f[1:-1, 1:-1, 1:-1]
        + c1 * (f[:-2, 1:-1, 1:-1] + f[2:, 1:-1, 1:-1]
                + f[1:-1, :-2, 1:-1] + f[1:-1, 2:, 1:-1]
                + f[1:-1, 1:-1, :-2] + f[1:-1, 1:-1, 2:])
    )
    out = f.clone()
    out[1:-1, 1:-1, 1:-1] = interior
    return out.to(u.dtype)


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
