"""Shared helpers of the LM substrate's parity tests: the JAX package's
trees and batches carried into the port through numpy, and the error
measures the tests state their tolerances in."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.models.lm import params_from_numpy


def np32(a) -> np.ndarray:
    """A JAX array as numpy, bf16 widened to f32 (lossless)."""
    return np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16
                      else a)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Single-threaded torch for a test module: its tensors are small, and
    the suite runs several workers on the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def jax_params(cfg):
    """The reference's initial parameters of `cfg` (key 0), drawn once a
    process: the reference's draw is the slow part of these tests."""
    from repro.models.lm import init_params
    return init_params(cfg, jax.random.key(0))


def port_params(jax_params) -> dict:
    """The reference's parameter tree, carried into the port on the CPU."""
    return params_from_numpy(jax.tree.map(np32, jax_params), "cpu")


def port_batch(batch: dict) -> dict:
    return {k: (torch.from_numpy(np.array(np32(v))).to(torch.bfloat16)
                if v.dtype == jnp.bfloat16
                else torch.from_numpy(np.array(np32(v))))
            for k, v in batch.items()}


def jax_batch(cfg, b=2, t=32, seed=0) -> dict:
    """tests/test_models.py's batch."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": jnp.asarray(rng.integers(0, cfg.vocab_size, (b, t))),
             "labels": jnp.asarray(rng.integers(0, cfg.vocab_size, (b, t)))}
    if cfg.enc_dec:
        batch["enc_inputs"] = jnp.asarray(
            rng.normal(0, 1, (b, t, cfg.d_model)), jnp.bfloat16)
    if cfg.frontend == "vlm":
        batch["patch_embeds"] = jnp.asarray(
            rng.normal(0, 1, (b, cfg.n_patches, cfg.d_model)), jnp.bfloat16)
    return batch


def as_np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np32(t)


def rel_l2(want, got) -> float:
    """||got - want|| / ||want|| over all elements, in float64."""
    w = np.asarray(as_np(want), np.float64)
    g = np.asarray(as_np(got), np.float64)
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))
