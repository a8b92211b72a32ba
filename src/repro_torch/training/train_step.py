"""train_step: loss -> grads -> (optional int8 error-feedback compression)
-> AdamW, the JAX package's step on one device."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.lm import lm_loss
from repro_torch.models.tree import leaves, unflatten_like
from repro_torch.training import adamw, compression

F32 = torch.float32


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                    compress_pod_grads: bool = False,
                    microbatches: int = 1,
                    accum_dtype=torch.float32):
    """Returns train_step(params, opt_state, batch) -> (params, opt, metrics).

    microbatches > 1 runs the batch in slices, accumulating grads in
    `accum_dtype` (the activation-memory knob; bf16 halves the grad
    buffer). The returned state holds the old state's moments, updated in
    place (`adamw.apply_updates`)."""

    def _value_and_grad(params, batch):
        flat = [p.detach().requires_grad_(True) for p in leaves(params)]
        with torch.enable_grad():
            loss = lm_loss(unflatten_like(params, flat), cfg, batch)
            # a leaf the loss does not use gets zeros, as in jax.grad
            grads = torch.autograd.grad(loss, flat, allow_unused=True,
                                        materialize_grads=True)
        return loss.detach(), unflatten_like(params, list(grads))

    def _grads(params, batch):
        if microbatches == 1:
            return _value_and_grad(params, batch)
        acc = [torch.zeros(p.shape, dtype=accum_dtype, device=p.device)
               for p in leaves(params)]
        loss_sum = torch.zeros((), dtype=F32,
                               device=batch["labels"].device)
        mb = batch["labels"].shape[0] // microbatches
        for i in range(microbatches):
            part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            loss, g = _value_and_grad(params, part)
            for a, gi in zip(acc, leaves(g)):
                a += gi.to(accum_dtype)
            loss_sum = loss_sum + loss
        grads = unflatten_like(params, [a / microbatches for a in acc])
        return loss_sum / microbatches, grads

    def train_step(params, opt_state, batch):
        loss, grads = _grads(params, batch)
        if compress_pod_grads:
            grads, new_resid = compression.compress_with_feedback(
                grads, opt_state["resid"])
        new_params, new_opt = adamw.apply_updates(
            params, grads, opt_state["adam"], opt_cfg)
        # summed over the leaves in pytree order, as the reference
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.to(F32)))
                               for g in leaves(grads)))
        state = {"adam": new_opt}
        if compress_pod_grads:
            state["resid"] = new_resid
        return new_params, state, {"loss": loss, "grad_norm": gnorm}

    return train_step


def init_state(params, opt_cfg: adamw.AdamWConfig,
               compress_pod_grads: bool = False):
    state = {"adam": adamw.init_opt_state(params, opt_cfg)}
    if compress_pod_grads:
        state["resid"] = compression.init_residuals(params)
    return state
