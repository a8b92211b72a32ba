"""AdamW with configurable moment precision, written out (not
`torch.optim.AdamW`, whose bf16 parameters get bf16 moments and whose
decay is applied in another order): the JAX package's arithmetic.

The update runs slice by slice along each leaf's leading dimension and
writes the moments in place, so the f32 temporaries of one slice, not of
the whole leaf, are live at once: at full width the largest stacked leaf
(granite-moe-3b-a800m's experts' w_gate, 1.21e9 elements) would need ~4.8
GB per temporary.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.models.tree import leaves, unflatten_like

F32 = torch.float32
# elements of a leaf updated at once (a slice's f32 temporaries: 256 MB)
SLICE_ELEMENTS = 1 << 26


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    moment_dtype: Any = torch.float32   # torch.bfloat16 for >=100B params
    warmup_steps: int = 100


def init_opt_state(params, cfg: AdamWConfig):
    def zeros(p):
        return torch.zeros(p.shape, dtype=cfg.moment_dtype, device=p.device)
    flat = leaves(params)
    dev = flat[0].device if flat else None
    return {"m": unflatten_like(params, [zeros(p) for p in flat]),
            "v": unflatten_like(params, [zeros(p) for p in flat]),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _schedule(step: torch.Tensor, cfg: AdamWConfig) -> torch.Tensor:
    warm = torch.clamp((step + 1) / cfg.warmup_steps, max=1.0)
    return cfg.lr * warm


def apply_updates(params, grads, state, cfg: AdamWConfig):
    """-> (new params, new state). The moments of `state` are updated in
    place (the returned state holds them), so `state` must not be reused."""
    step = state["step"] + 1
    stepf = step.to(F32)
    lr = _schedule(stepf, cfg)
    b1 = torch.tensor(cfg.b1, dtype=F32, device=stepf.device)
    b2 = torch.tensor(cfg.b2, dtype=F32, device=stepf.device)
    bc1 = 1.0 - b1 ** stepf
    bc2 = 1.0 - b2 ** stepf
    one_b1, one_b2 = 1 - b1, 1 - b2

    def upd(p, g, m, v):
        gf = g.to(F32)
        mf = b1 * m.to(F32) + one_b1 * gf
        vf = b2 * v.to(F32) + one_b2 * gf * gf
        mhat = mf / bc1
        vhat = vf / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay \
            * p.to(F32)
        m.copy_(mf)
        v.copy_(vf)
        return (p.to(F32) - lr * delta).to(p.dtype)

    flat_p = leaves(params)
    new_p = []
    for p, g, m, v in zip(flat_p, leaves(grads), leaves(state["m"]),
                          leaves(state["v"])):
        if p.dim() == 0:
            new_p.append(upd(p, g, m, v))
            continue
        rows = max(1, SLICE_ELEMENTS // max(1, p[0].numel()))
        out = torch.empty_like(p)
        for i in range(0, p.shape[0], rows):
            sl = slice(i, i + rows)
            out[sl] = upd(p[sl], g[sl], m[sl], v[sl])
        new_p.append(out)
    return unflatten_like(params, new_p), {"m": state["m"], "v": state["v"],
                                           "step": step}
