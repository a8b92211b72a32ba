"""One train step of the PyTorch port against the JAX package on the CPU,
for every reduced config, on the reference's parameters carried across
(`params_from_numpy`): gradients, AdamW moments, updated parameters,
loss and grad_norm (forward and loss in bf16 are held in
test_torch_lm_forward_parity.py).

Gradients are compared in f32: in bf16 they differ by rounding that some
archs amplify (RWKV's u_bonus gradient differs about as much between the
reference's own jit and eager runs); the bf16 AdamW arithmetic is held in
test_torch_lm_training.py. With f32 parameters and f32 input embeddings
(the head stays bf16: the loss feeds it bf16 hidden states, and torch does
not promote a bf16 x f32 matmul as jax does) the packages compute the same
function, so loss and grad_norm agree within rtol 1e-5 (the chunked-CE
tolerance), each gradient leaf, read from the first moment (m = (1 - b1) g
after one step), and each second moment within a relative L2 error of
2e-3, and the updated parameters element by element: Adam's first step
moves each weight by lr_1 (sign(g) + wd p), so the packages agree but
where a gradient's sign differs (a gradient within rounding of zero),
where they are 2 lr_1 apart; bound 2 lr_1 plus one ulp of the weight's
dtype. seamless-m4t-medium's encoder casts its input to bf16 and meets f32
weights, so its train step is held in bf16 instead: the loss within rtol
1e-3 and the updated parameters as above.

Torch runs single-threaded here (`one_torch_thread`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import all_archs as jax_archs
from repro.training.adamw import AdamWConfig as JaxAdamW
from repro.training.train_step import init_state as jax_init_state
from repro.training.train_step import make_train_step as jax_train_step
from repro_torch.configs.base import all_archs
from repro_torch.models.tree import leaves
from repro_torch.training.adamw import AdamWConfig
from repro_torch.training.train_step import init_state, make_train_step

from _lm_parity import (as_np, jax_batch, jax_params,  # noqa: F401
                        one_torch_thread,
                        port_batch, port_params, rel_l2)

ARCH_IDS = sorted(jax_archs())
LR1 = AdamWConfig().lr * 2 / AdamWConfig().warmup_steps   # step 1's lr


def _f32_tree(jp):
    """The reference tree in f32 but for the head, which meets bf16
    hidden states."""
    out = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    out["head"] = jp["head"]
    return out


def _step_both(jc, tc, jp, tp, jb, tb):
    new_j, state_j, met_j = jax.jit(jax_train_step(jc, JaxAdamW()))(
        jp, jax_init_state(jp, JaxAdamW()), jb)
    new_t, state_t, met_t = make_train_step(tc, AdamWConfig())(
        tp, init_state(tp, AdamWConfig()), tb)
    return (new_j, state_j, met_j), (new_t, state_t, met_t)


def _assert_first_step_params(new_j, new_t):
    for a, b in zip(jax.tree.leaves(new_j), leaves(new_t)):
        want, got = as_np(a).astype(np.float64), as_np(b).astype(np.float64)
        eps = 2.0 ** -7 if a.dtype == jnp.bfloat16 else 2.0 ** -23
        bound = 2 * LR1 * (1 + 1e-3) + eps * np.abs(want)
        assert (np.abs(got - want) <= bound).all(), \
            np.abs(got - want).max()


def test_bf16_train_step_encoder_decoder():
    jc = jax_archs()["seamless-m4t-medium"].reduced
    tc = all_archs()["seamless-m4t-medium"].reduced
    jp = jax_params(jc)
    tp = port_params(jp)
    jb = jax_batch(jc)
    (new_j, _, met_j), (new_t, _, met_t) = _step_both(
        jc, tc, jp, tp, jb, port_batch(jb))
    np.testing.assert_allclose(float(met_t["loss"]), float(met_j["loss"]),
                               rtol=1e-3)
    assert np.isfinite(float(met_t["grad_norm"]))
    _assert_first_step_params(new_j, new_t)


@pytest.mark.parametrize("arch", [a for a in ARCH_IDS
                                  if not jax_archs()[a].reduced.enc_dec])
def test_f32_gradients_and_adamw_step(arch):
    jc, tc = jax_archs()[arch].reduced, all_archs()[arch].reduced
    jp = _f32_tree(jax_params(jc))
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(as_np(a))).to(
        torch.bfloat16 if a.dtype == jnp.bfloat16 else torch.float32), jp)
    rng = np.random.default_rng(1)
    jb = jax_batch(jc)
    del jb["tokens"]
    jb["embeds"] = jnp.asarray(rng.normal(0, 1, (2, 32, jc.d_model)),
                               jnp.float32)
    if "patch_embeds" in jb:
        jb["patch_embeds"] = jb["patch_embeds"].astype(jnp.float32)
    tb = port_batch(jb)
    # one train step: moments, updated params, grad_norm
    (new_j, st_j, met_j), (new_t, st_t, met_t) = _step_both(
        jc, tc, jp, tp, jb, tb)
    np.testing.assert_allclose(float(met_t["loss"]), float(met_j["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(met_t["grad_norm"]),
                               float(met_j["grad_norm"]), rtol=1e-5)
    for mom in ("m", "v"):
        for a, b in zip(jax.tree.leaves(st_j["adam"][mom]),
                        leaves(st_t["adam"][mom])):
            assert rel_l2(a, b) <= 2e-3, (mom, rel_l2(a, b))
    assert int(st_t["adam"]["step"]) == int(st_j["adam"]["step"]) == 1
    _assert_first_step_params(new_j, new_t)
