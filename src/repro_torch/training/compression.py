"""Error-feedback int8 gradient compression (Karimireddy et al., 2019).

Each leaf is quantized to int8 with a per-tensor scale; the quantization
residual is kept and folded into the next step, which makes the scheme
unbiased over time. Elementwise, so its words are the JAX package's.
"""
from __future__ import annotations

import torch

from repro_torch.models.tree import leaves, unflatten_like

F32 = torch.float32


def quantize(g: torch.Tensor):
    scale = torch.clamp(torch.abs(g).max(), min=1e-12) / 127.0
    # torch.round is half-to-even, as jnp.round
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale.to(F32)


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(F32) * scale


def compress_with_feedback(grads, residuals):
    """-> (quantized grads as f32 trees, new residuals).
    Residual = g - dequant(quant(g))."""
    dqs, rs = [], []
    for g, r in zip(leaves(grads), leaves(residuals)):
        g = g.to(F32) + r
        q, s = quantize(g)
        dq = dequantize(q, s)
        dqs.append(dq)
        rs.append(g - dq)
    return unflatten_like(grads, dqs), unflatten_like(grads, rs)


def init_residuals(params):
    return unflatten_like(params, [torch.zeros(p.shape, dtype=F32,
                                               device=p.device)
                                   for p in leaves(params)])
