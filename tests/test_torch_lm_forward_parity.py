"""The whole LM of the PyTorch port against the JAX package on the CPU,
bf16 as configured, for every reduced config, on the reference's
parameters carried across (`params_from_numpy`): forward hidden states
within a relative L2 error of 0.05 (tests/test_models.py's MoE-vs-dense
value) and lm_loss within rtol 1e-3. A whole bf16 model is compared by its
relative L2 error, not element by element: under jit XLA keeps a bf16 dot
in f32 where an f32 op consumes it, the port rounds as written, and
ill-conditioned steps amplify that ulp in a few elements, as they do
between the reference's own jit and eager runs. Gradients and the AdamW
step are held in test_torch_lm_train_parity.py. Torch runs single-threaded
here (`one_torch_thread`).
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.base import all_archs as jax_archs
from repro.models import lm as JM
from repro_torch.configs.base import all_archs
from repro_torch.models import lm as M

from _lm_parity import (jax_batch, jax_params,  # noqa: F401
                        one_torch_thread, port_batch, port_params, rel_l2)

ARCH_IDS = sorted(jax_archs())


def _forward_and_loss(params, cfg, batch):
    hidden = JM.forward(params, cfg, tokens=batch.get("tokens"),
                        enc_inputs=batch.get("enc_inputs"),
                        patch_embeds=batch.get("patch_embeds"))
    return hidden, JM.ce_loss(params, cfg, hidden, batch["labels"])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_bf16_forward_and_loss(arch):
    jc, tc = jax_archs()[arch].reduced, all_archs()[arch].reduced
    jp = jax_params(jc)
    tp = port_params(jp)
    jb = jax_batch(jc)
    tb = port_batch(jb)
    want, loss_j = jax.jit(lambda p, b: _forward_and_loss(p, jc, b))(jp, jb)
    with torch.no_grad():
        got = M.forward(tp, tc, tokens=tb["tokens"],
                        enc_inputs=tb.get("enc_inputs"),
                        patch_embeds=tb.get("patch_embeds"))
        loss_t = M.ce_loss(tp, tc, got, tb["labels"])
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert rel_l2(want, got) <= 0.05
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-3)
