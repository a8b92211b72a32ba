"""Model assembly: parameter init, the forward over scan groups, chunked
CE loss, and the carry-across of the JAX package's parameter trees.

Layout (the JAX package's, leaf for leaf):
* every per-layer parameter is STACKED with a leading `repeats` dim; the
  forward loops over the repeats and checkpoints each unit (`remat`);
* logits are never materialized (B, T, V): the loss runs over sequence
  chunks, each recomputed in the backward;
* the in-embedding and the out-head are stored separately even for tied
  archs (param counts are the reference's analytic ones).

Initial parameters are drawn from a `torch.Generator` with the reference's
shapes, dtypes and scales; their words differ from the reference's
(`jax.random`), so parity is held on carried-across trees
(`params_from_numpy` / `params_to_numpy`).
"""
from __future__ import annotations

import functools
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import recurrent as R
from repro_torch.models import tp as T
from repro_torch.models.tree import leaves, tree_map, unflatten_like

BF16 = torch.bfloat16
F32 = torch.float32

# the leaves the reference keeps in f32; every other float leaf is bf16
F32_LEAVES = frozenset({"w_base", "w_lora_a", "w_lora_b", "u_bonus",
                        "ln_x_scale", "w_rg", "b_rg", "w_ig", "b_ig",
                        "lambda"})


# ---------------------------------------------------------------------------
# parameter init
# ---------------------------------------------------------------------------

class _Init:
    """Draws leaves of shape `lead + shape` (lead = the stacking dims) on
    `device` from `gen` (None on the meta device, which draws nothing)."""

    def __init__(self, gen: torch.Generator | None, device, lead=()):
        self.gen, self.device, self.lead = gen, torch.device(device), lead

    def stacked(self, r: int) -> "_Init":
        return _Init(self.gen, self.device, self.lead + (r,))

    def normal(self, shape) -> torch.Tensor:
        return torch.randn(self.lead + tuple(shape), generator=self.gen,
                           dtype=F32, device=self.device)

    def dense(self, fan_in: int, shape, dtype=BF16) -> torch.Tensor:
        return (self.normal(shape) / np.sqrt(fan_in)).to(dtype)

    def full(self, shape, value: float, dtype=BF16) -> torch.Tensor:
        return torch.full(self.lead + tuple(shape), value, dtype=dtype,
                          device=self.device)

    def zeros(self, shape, dtype=BF16) -> torch.Tensor:
        return self.full(shape, 0.0, dtype)


def _init_mlp(ini: _Init, d, f):
    return {"w_gate": ini.dense(d, (d, f)), "w_up": ini.dense(d, (d, f)),
            "w_down": ini.dense(f, (f, d))}


def _init_attn(ini: _Init, cfg: ModelConfig):
    d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {"wq": ini.dense(d, (d, h * dh)),
         "wk": ini.dense(d, (d, hkv * dh)),
         "wv": ini.dense(d, (d, hkv * dh)),
         "wo": ini.dense(h * dh, (h * dh, d)),
         "ln1": ini.zeros((d,)), "ln2": ini.zeros((d,))}
    p.update(_init_mlp(ini, d, cfg.d_ff))
    if cfg.post_norms:
        p["ln1_post"] = ini.zeros((d,))
        p["ln2_post"] = ini.zeros((d,))
    return p


def _init_moe(ini: _Init, cfg: ModelConfig):
    d, fe = cfg.d_model, cfg.d_ff_expert
    ep = padded_experts(cfg)
    p = {"router": ini.dense(d, (d, cfg.n_experts)),
         "w_gate": ini.dense(d, (ep, d, fe)),
         "w_up": ini.dense(d, (ep, d, fe)),
         "w_down": ini.dense(fe, (ep, fe, d))}
    if cfg.n_shared_experts:
        p["shared"] = _init_mlp(ini, d, cfg.n_shared_experts * fe)
    return p


def _init_mla(ini: _Init, cfg: ModelConfig):
    d, h = cfg.d_model, cfg.n_heads
    dn, dr, dv = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    return {"wq_a": ini.dense(d, (d, cfg.q_lora)),
            "q_norm": ini.zeros((cfg.q_lora,)),
            "wq_b": ini.dense(cfg.q_lora, (cfg.q_lora, h * (dn + dr))),
            "wkv_a": ini.dense(d, (d, cfg.kv_lora + dr)),
            "kv_norm": ini.zeros((cfg.kv_lora,)),
            "wkv_b": ini.dense(cfg.kv_lora, (cfg.kv_lora, h * (dn + dv))),
            "wo": ini.dense(h * dv, (h * dv, d)),
            "ln1": ini.zeros((d,)), "ln2": ini.zeros((d,))}


def _init_rwkv(ini: _Init, cfg: ModelConfig):
    d = cfg.d_model
    h = d // cfg.rwkv_head_dim
    return {"mix_rkvw": ini.full((1, 1, d), 0.5),
            "wr": ini.dense(d, (d, d)), "wk": ini.dense(d, (d, d)),
            "wv": ini.dense(d, (d, d)), "wg": ini.dense(d, (d, d)),
            "wo": ini.dense(d, (d, d)),
            "w_base": ini.full((d,), -6.0, F32),
            # the reference rounds these two through bf16, then to f32
            "w_lora_a": ini.dense(d, (d, 64)).to(F32),
            "w_lora_b": ini.dense(64, (64, d)).to(F32),
            "u_bonus": ini.zeros((d,), F32),
            "ln_x_scale": ini.full((h, cfg.rwkv_head_dim), 1.0, F32),
            "ln1": ini.zeros((d,)), "ln2": ini.zeros((d,)),
            "mix_ch": ini.full((1, 1, d), 0.5),
            "wk_ch": ini.dense(d, (d, cfg.d_ff)),
            "wv_ch": ini.dense(cfg.d_ff, (cfg.d_ff, d)),
            "wr_ch": ini.dense(d, (d, d))}


def _init_rglru(ini: _Init, cfg: ModelConfig):
    d, w = cfg.d_model, cfg.lru_width or cfg.d_model
    p = _init_mlp(ini, d, cfg.d_ff)
    p.update({"w_gate_branch": ini.dense(d, (d, w)),
              "w_in": ini.dense(d, (d, w)),
              "conv_w": (ini.normal((cfg.conv_width, w)) * 0.1).to(BF16),
              "conv_b": ini.zeros((w,)),
              "w_rg": ini.dense(w, (w, w)).to(F32),
              "b_rg": ini.zeros((w,), F32),
              "w_ig": ini.dense(w, (w, w)).to(F32),
              "b_ig": ini.zeros((w,), F32),
              "lambda": ini.full((w,), 0.65, F32),
              "w_out": ini.dense(w, (w, d)),
              "ln1": ini.zeros((d,)), "ln2": ini.zeros((d,))})
    return p


def _init_xattn(ini: _Init, cfg: ModelConfig):
    d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = _init_attn(ini, cfg)
    p.update({"xq": ini.dense(d, (d, h * dh)),
              "xk": ini.dense(d, (d, hkv * dh)),
              "xv": ini.dense(d, (d, hkv * dh)),
              "xo": ini.dense(h * dh, (h * dh, d)),
              "ln3": ini.zeros((d,))})
    return p


_INIT = {"attn": _init_attn,
         "attn_local": _init_attn,
         "rwkv": _init_rwkv,
         "rglru": _init_rglru,
         "rglru_attn": _init_attn,
         "xattn": _init_xattn}


def padded_experts(cfg: ModelConfig, tp: int | None = None) -> int:
    m = tp or cfg.expert_pad_multiple
    return -(-cfg.n_experts // m) * m if cfg.n_experts else 0


def _init_block(kind: str, ini: _Init, cfg: ModelConfig):
    if kind == "moe_attn":
        p = _init_attn(ini, cfg)
        for name in ("w_gate", "w_up", "w_down"):
            p.pop(name)
        p["moe"] = _init_moe(ini, cfg)
        return p
    if kind in ("mla", "mla_dense"):
        p = _init_mla(ini, cfg)
        if kind == "mla":
            p["moe"] = _init_moe(ini, cfg)
        else:
            p.update(_init_mlp(ini, cfg.d_model, cfg.d_ff_dense_first
                               or cfg.d_ff))
        return p
    return _INIT[kind](ini, cfg)


def init_params(cfg: ModelConfig, seed_or_generator, *,
                device="cuda") -> dict:
    """The parameter tree, drawn on `device` from `seed_or_generator` (an
    int seeds a new generator on that device). A CUDA device with no GPU
    present raises; the meta device gives shapes and dtypes only."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("init_params(device='cuda') needs a CUDA GPU and "
                           "none is available; pass device='cpu'")
    gen = None
    if device.type != "meta":
        gen = seed_or_generator
        if not isinstance(gen, torch.Generator):
            gen = torch.Generator(device=device).manual_seed(int(gen))
    ini = _Init(gen, device)
    d, vp = cfg.d_model, cfg.vocab_padded
    params: dict[str, Any] = {
        "embed": (ini.normal((vp, d)) * 0.02).to(BF16),
        "head": ini.dense(d, (d, vp)),
        "final_norm": ini.zeros((d,)),
        "groups": [],
    }
    for grp in cfg.groups:
        params["groups"].append(
            {f"b{bi}": _init_block(kind, ini.stacked(grp.repeats), cfg)
             for bi, kind in enumerate(grp.unit)})
    if cfg.enc_dec:
        params["encoder"] = _init_block(
            "attn", ini.stacked(cfg.n_enc_layers), cfg)
        params["enc_norm"] = ini.zeros((d,))
    return params


def init_params_shape_only(cfg: ModelConfig) -> dict:
    """The tree's shapes and dtypes, on the meta device (no storage)."""
    return init_params(cfg, 0, device="meta")


def params_from_numpy(tree, device) -> dict:
    """The JAX package's parameter tree as numpy arrays (bf16 leaves passed
    as f32, which is lossless) -> the port's tree on `device`, with the
    reference's dtypes (bf16 but for `F32_LEAVES`)."""
    def conv(path_leaf):
        name, a = path_leaf
        t = torch.from_numpy(np.array(a))
        if t.is_floating_point():
            t = t.to(F32 if name in F32_LEAVES else BF16)
        return t.to(device)
    return _map_named(conv, tree)


def params_to_numpy(tree) -> dict:
    """The port's tree -> numpy arrays (bf16 as f32, losslessly), the form
    `params_from_numpy` and the JAX package's converters take."""
    def conv(t: torch.Tensor):
        if t.dtype == BF16:
            t = t.to(F32)
        return t.detach().cpu().numpy()
    return tree_map(conv, tree)


def _map_named(fn, tree, name: str = ""):
    """fn((leaf's dict key, leaf)) over a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: _map_named(fn, v, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_named(fn, v, name) for v in tree)
    return fn((name, tree))


def unstack(tree) -> list:
    """The repeats of a stacked block tree, one tree each. Views through
    `unbind`, whose backward stacks the repeats' grads in one tensor (a
    per-repeat index would write a zero-filled stacked tensor each)."""
    parts = [t.unbind(0) for t in leaves(tree)]
    return [unflatten_like(tree, [p[r] for p in parts])
            for r in range(len(parts[0]))]


# ---------------------------------------------------------------------------
# block application (train/prefill mode)
# ---------------------------------------------------------------------------

def _norm(p, name, x, cfg):
    return L.rms_norm(x, p[name], cfg.norm_eps)


def _pin_batch(x, cfg: ModelConfig):
    """Pin the activation batch dim to the mesh axes `cfg.act_axes`: a
    DTensor is redistributed to Shard(0) over those axes (replicated over
    the others). A plain or meta tensor has no mesh, and passes as it is;
    so does everything when act_axes is empty (the default)."""
    if not cfg.act_axes:
        return x
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    return x.redistribute(mesh, [Shard(0) if name in cfg.act_axes
                                 else Replicate()
                                 for name in mesh.mesh_dim_names])


def apply_block(kind: str, p: dict, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor, enc: torch.Tensor | None = None):
    """One block. A DTensor step is pinned first (`_pin_batch`), and its
    mixers and MLPs run as tensor-parallel regions (models/tp.py)."""
    x = _pin_batch(x, cfg)
    if kind in ("attn", "attn_local", "rglru_attn", "moe_attn", "xattn"):
        window = cfg.window if kind in ("attn_local", "rglru_attn") else None
        a = L.attention(p, _norm(p, "ln1", x, cfg), cfg, causal=True,
                        window=window, positions=positions)
        if cfg.post_norms:
            a = _norm(p, "ln1_post", a, cfg)
        x = x + a
        if kind == "xattn":
            x = x + L.cross_attention(
                {"wq": p["xq"], "wk": p["xk"], "wv": p["xv"], "wo": p["xo"]},
                _norm(p, "ln3", x, cfg), enc, cfg)
        h = _norm(p, "ln2", x, cfg)
        m = L.moe_mlp(p["moe"], h, cfg) if kind == "moe_attn" \
            else L.glu_mlp(p, h, cfg)
        if cfg.post_norms:
            m = _norm(p, "ln2_post", m, cfg)
        return x + m
    if kind in ("mla", "mla_dense"):
        x = x + L.mla_attention(p, _norm(p, "ln1", x, cfg), cfg, positions)
        h = _norm(p, "ln2", x, cfg)
        m = L.moe_mlp(p["moe"], h, cfg) if kind == "mla" \
            else L.glu_mlp(p, h, cfg)
        return x + m
    if kind == "rwkv":
        tm, _ = R.rwkv_time_mix(p, _norm(p, "ln1", x, cfg), cfg)
        x = x + tm
        cm, _ = R.rwkv_channel_mix(p, _norm(p, "ln2", x, cfg), cfg)
        return x + cm
    if kind == "rglru":
        rec, _ = R.rg_lru(p, _norm(p, "ln1", x, cfg), cfg)
        x = x + rec
        return x + L.glu_mlp(p, _norm(p, "ln2", x, cfg), cfg)
    raise ValueError(kind)


def _encoder_block(p, x, cfg):
    x = _pin_batch(x, cfg)
    a = L.attention(p, _norm(p, "ln1", x, cfg), cfg, causal=False,
                    window=None,
                    positions=torch.arange(x.shape[1], device=x.device))
    x = x + a
    return x + L.glu_mlp(p, _norm(p, "ln2", x, cfg), cfg)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def embed_tokens(params, tokens, cfg: ModelConfig):
    """A DTensor step in the 2D mode looks up this rank's columns of the
    table (split on D over 'model') and all-gathers them."""
    tp = T.region(tokens, cfg, cfg.d_model)
    # F.embedding: its backward on the card sorts the ids (deterministic)
    x = F.embedding(tp.local(tokens), tp.column(params["embed"])).to(BF16)
    if cfg.scale_embed:
        # the reference rounds sqrt(d) to bf16 before it multiplies
        x = x * float(torch.tensor(np.sqrt(cfg.d_model), dtype=BF16))
    return tp.exit_gather(x, 2)


# matmul outputs: what remat_policy="dots" keeps (jax's checkpoint_dots)
_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                   torch.ops.aten.addmm.default,
                   torch.ops.aten.baddbmm.default})


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, x, policy: str = "none"):
    """fn(x) checkpointed: the backward recomputes it, saving only its input
    ("none") or its matmul outputs too ("dots")."""
    if not torch.is_grad_enabled():
        return fn(x)
    kw = {}
    if policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)
    return checkpoint(fn, x, use_reentrant=False, **kw)


def forward(params, cfg: ModelConfig, tokens=None, *, embeds=None,
            enc_inputs=None, patch_embeds=None, remat: bool = True):
    """-> final hidden states (B, T, D). Inputs:
    tokens (B,T) int, or embeds (audio stub); patch_embeds for vlm;
    enc_inputs (B,S_enc,D) for enc-dec."""
    x = embeds if embeds is not None else embed_tokens(params, tokens, cfg)
    if patch_embeds is not None:  # vlm stub: patches replace the prefix
        x = torch.cat([patch_embeds.to(x.dtype),
                       x[:, patch_embeds.shape[1]:]], 1)
    positions = torch.arange(x.shape[1], device=x.device)

    enc = None
    if cfg.enc_dec:
        e = enc_inputs.to(BF16)
        for p_r in unstack(params["encoder"]):
            fn = functools.partial(_encoder_block, p_r, cfg=cfg)
            e = _remat(fn, e) if remat else fn(e)
        enc = _norm(params, "enc_norm", e, cfg)

    x = _pin_batch(x, cfg)
    # cfg.scan_unroll changes only the reference's XLA cost analysis; these
    # loops are Python loops either way
    for grp, gp in zip(cfg.groups, params["groups"]):
        for up in unstack(gp):
            def unit(h, _grp=grp, _up=up):
                for bi, kind in enumerate(_grp.unit):
                    h = apply_block(kind, _up[f"b{bi}"], h, cfg, positions,
                                    enc)
                return _pin_batch(h, cfg)
            x = _remat(unit, x, cfg.remat_policy) if remat else unit(x)
    return _norm(params, "final_norm", x, cfg)


# ---------------------------------------------------------------------------
# chunked cross-entropy
# ---------------------------------------------------------------------------

def ce_loss(params, cfg: ModelConfig, hidden, labels, *, chunk: int = 512):
    """hidden (B,T,D), labels (B,T) -> mean CE. Runs T in chunks; each
    chunk's (B,chunk,V) logits are recomputed in the backward, never
    stored. The padded vocabulary columns stay in the log-sum-exp. A
    DTensor step in the 2D mode takes it on this rank's vocabulary columns
    of the head (split over 'model'): each chunk's local maximum, exp-sum
    and true logit are all-reduced over 'model', so no logits are
    gathered; the maximum only steadies the exponent and there carries no
    gradient."""
    b, t, d = hidden.shape
    chunk = min(chunk, t)
    n_chunks = t // chunk
    assert t % chunk == 0, (t, chunk)
    tp = T.region(hidden, cfg, cfg.vocab_padded)
    head = tp.column(params["head"])
    hidden, labels = tp.enter(hidden), tp.local(labels)

    def chunk_loss(lab, h):
        logits = (h.to(BF16) @ head).to(F32)
        logits = L.softcap(logits, cfg.final_softcap)
        m = tp.all_max(logits.amax(-1, keepdim=True))
        lse = torch.log(tp.all_sum(torch.exp(logits - m).sum(-1),
                                   partial_grad=False)) + m[..., 0]
        v = logits.shape[-1]
        onehot = (torch.arange(tp.rank * v, (tp.rank + 1) * v,
                               device=logits.device)
                  [None, None, :] == lab[..., None])
        true_logit = tp.all_sum(torch.where(onehot, logits, 0.0).sum(-1),
                                partial_grad=False)
        return (lse - true_logit).sum()

    total = torch.zeros((), dtype=F32, device=hidden.device)
    for i in range(n_chunks):
        sl = slice(i * chunk, (i + 1) * chunk)
        h_i, lab_i = hidden[:, sl], labels[:, sl]
        total = total + _remat(functools.partial(chunk_loss, lab_i), h_i)
    return tp.exit_total(total) / (b * t)


def lm_loss(params, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    hidden = forward(params, cfg,
                     tokens=batch.get("tokens"),
                     embeds=batch.get("embeds"),
                     enc_inputs=batch.get("enc_inputs"),
                     patch_embeds=batch.get("patch_embeds"))
    return ce_loss(params, cfg, hidden, batch["labels"])
