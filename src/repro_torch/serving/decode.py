"""serve_step: single-token decode with KV caches / recurrent states.

Cache layouts (per scan group, stacked over repeats; the JAX package's):

  gqa global : k/v (R, B, S_max, Hkv, Dh) bf16, positions implicit (<= pos)
  gqa local  : k/v (R, B, W, Hkv, Dh) ring buffer + kpos (R, B, W) int32
  MLA        : ckv (R, B, S, kv_lora) + kpe (R, B, S, dr): kv_lora + dr
               values per token instead of 2*Hkv*Dh (absorbed-matmul
               decode, DeepSeek-V2 Sec 2.1)
  rwkv       : prev_tm/prev_ch (R, B, 1, D) + s (R, B, H, dk, dv)
  rglru      : conv tail (R, B, cw-1, W) + h (R, B, W)
  xattn      : self cache + precomputed cross k/v

A step writes the new entries into the cache tensors in place and returns
the same structure, so a cache must not be reused after the step that
consumed it. `pos` is a Python int: nothing here reads a device value on
the host.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import lm as M
from repro_torch.models import recurrent as R

BF16 = torch.bfloat16
F32 = torch.float32


# ---------------------------------------------------------------------------
# cache init
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               enc_len: int = 0, *, device="cuda") -> list:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("init_cache(device='cuda') needs a CUDA GPU and "
                           "none is available; pass device='cpu'")
    caches = []
    for grp in cfg.groups:
        unit_cache = {}
        for bi, kind in enumerate(grp.unit):
            unit_cache[f"b{bi}"] = _init_block_cache(
                kind, cfg, grp.repeats, batch, max_seq, enc_len, device)
        caches.append(unit_cache)
    return caches


def _init_block_cache(kind, cfg, r, b, s, enc_len, device):
    hkv, dh, d = cfg.n_kv_heads, cfg.head_dim, cfg.d_model

    def zeros(*shape, dtype=BF16):
        return torch.zeros(shape, dtype=dtype, device=device)

    if kind in ("attn", "moe_attn", "xattn"):
        c = {"k": zeros(r, b, s, hkv, dh), "v": zeros(r, b, s, hkv, dh)}
        if kind == "xattn":
            c["xk"] = zeros(r, b, enc_len, hkv, dh)
            c["xv"] = zeros(r, b, enc_len, hkv, dh)
        return c
    if kind in ("attn_local", "rglru_attn"):
        w = min(cfg.window, s)
        return {"k": zeros(r, b, w, hkv, dh), "v": zeros(r, b, w, hkv, dh),
                "kpos": torch.full((r, b, w), -1, dtype=torch.int32,
                                   device=device)}
    if kind in ("mla", "mla_dense"):
        return {"ckv": zeros(r, b, s, cfg.kv_lora),
                "kpe": zeros(r, b, s, cfg.rope_head_dim)}
    if kind == "rwkv":
        h = d // cfg.rwkv_head_dim
        return {"prev_tm": zeros(r, b, 1, d), "prev_ch": zeros(r, b, 1, d),
                "s": zeros(r, b, h, cfg.rwkv_head_dim, cfg.rwkv_head_dim,
                           dtype=F32)}
    if kind == "rglru":
        w = cfg.lru_width or d
        return {"tail": zeros(r, b, cfg.conv_width - 1, w),
                "h": zeros(r, b, w, dtype=F32)}
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# single-token attention over a cache
# ---------------------------------------------------------------------------

def _attend_cache(q, k, v, mask, scale, cap):
    """q (B,1,H,Dh); k/v (B,S,Hkv,Dh); mask (B,S) -> (B,1,H*Dh)."""
    b, _, h, dh = q.shape
    hkv = k.shape[2]
    g = h // hkv
    s = torch.einsum("bqhgd,bkhd->bhgqk",
                     L.split_dims(q.to(F32), b, 1, hkv, g, dh),
                     k.to(F32)) * scale
    s = L.softcap(s, cap)
    s = torch.where(mask[:, None, None, None, :], s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.to(F32))
    return o.reshape(b, 1, h * dh).to(BF16)


def _rope_at(pos: int, dim: int, theta: float, device):
    """cos/sin (1, 1, dim/2) at position `pos` (no host-to-device copy)."""
    cos, sin = L.rope_freqs(torch.arange(pos, pos + 1, device=device), dim,
                            theta)
    return cos[None], sin[None]


def _decode_gqa(p, cache, x, cfg, pos: int, *, window=None):
    b = x.shape[0]
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = L.split_dims(x @ p["wq"], b, 1, h, dh)
    k = L.split_dims(x @ p["wk"], b, 1, hkv, dh)
    v = L.split_dims(x @ p["wv"], b, 1, hkv, dh)
    cos, sin = _rope_at(pos, dh, cfg.rope_theta, x.device)
    q = L.apply_rope(q, cos, sin)
    k = L.apply_rope(k, cos, sin)
    kc, vc = cache["k"], cache["v"]          # (B, S, Hkv, Dh), this layer's
    if window is None:
        s_max = kc.shape[1]
        kc[:, pos] = k[:, 0]
        vc[:, pos] = v[:, 0]
        mask = (torch.arange(s_max, device=x.device)[None] <= pos).expand(
            b, s_max)
    else:
        slot = pos % kc.shape[1]
        kc[:, slot] = k[:, 0]
        vc[:, slot] = v[:, 0]
        kpos = cache["kpos"]
        kpos[:, slot] = pos
        mask = (kpos <= pos) & (kpos > pos - window) & (kpos >= 0)
    o = _attend_cache(q, kc, vc, mask, 1.0 / np.sqrt(dh), cfg.attn_softcap)
    return o @ p["wo"]


def _decode_mla(p, cache, x, cfg, pos: int):
    """Absorbed-matmul MLA decode over the compressed cache."""
    b = x.shape[0]
    h = cfg.n_heads
    dn, dr, dv = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    cq = L.rms_norm(x @ p["wq_a"], p["q_norm"], cfg.norm_eps)
    q = L.split_dims(cq @ p["wq_b"], b, 1, h, dn + dr)
    q_nope, q_pe = q[..., :dn], q[..., dn:]
    cos, sin = _rope_at(pos, dr, cfg.rope_theta, x.device)
    q_pe = L.apply_rope(q_pe, cos, sin)
    ckv_full = x @ p["wkv_a"]
    ckv = L.rms_norm(ckv_full[..., :cfg.kv_lora], p["kv_norm"], cfg.norm_eps)
    kpe = ckv_full[..., cfg.kv_lora:].reshape(b, 1, dr)
    kpe = L.apply_rope(kpe[:, :, None], cos, sin)[:, :, 0]
    ckv_c, kpe_c = cache["ckv"], cache["kpe"]
    s_max = ckv_c.shape[1]
    ckv_c[:, pos] = ckv.reshape(b, -1)
    kpe_c[:, pos] = kpe.reshape(b, -1)
    wkv_b = L.split_dims(p["wkv_b"], cfg.kv_lora, h, dn + dv)
    w_uk, w_uv = wkv_b[..., :dn], wkv_b[..., dn:]
    q_eff = torch.einsum("bhd,khd->bhk", q_nope[:, 0].to(F32),
                         w_uk.to(F32))                       # (B,H,kv_lora)
    scores = torch.einsum("bhk,bsk->bhs", q_eff, ckv_c.to(F32)) \
        + torch.einsum("bhr,bsr->bhs", q_pe[:, 0].to(F32), kpe_c.to(F32))
    scores = scores / np.sqrt(dn + dr)
    mask = torch.arange(s_max, device=x.device)[None, None] <= pos
    probs = torch.softmax(torch.where(mask, scores, -1e30), -1)
    ctx_c = torch.einsum("bhs,bsk->bhk", probs, ckv_c.to(F32))
    o = torch.einsum("bhk,khd->bhd", ctx_c, w_uv.to(F32))    # (B,H,dv)
    return o.reshape(b, 1, h * dv).to(BF16) @ p["wo"]


def _decode_rwkv_tm(p, cache_s, prev, x, cfg):
    """T=1 exact recurrence -> (out, new state, x: the next prev_tm)."""
    b, _, d = x.shape
    dh = cfg.rwkv_head_dim
    h = d // dh
    xm = x + (prev - x) * p["mix_rkvw"].to(x.dtype)
    r = L.split_dims(xm @ p["wr"], b, h, dh).to(F32)
    k = L.split_dims(xm @ p["wk"], b, h, dh).to(F32)
    v = L.split_dims(xm @ p["wv"], b, h, dh).to(F32)
    g = torch.nn.functional.silu(xm @ p["wg"])
    w = L.split_dims(R._decay(p, xm), b, h, dh)
    u = p["u_bonus"].reshape(h, dh).to(F32)
    y = torch.einsum("bhk,bhkv->bhv", r, cache_s) \
        + torch.einsum("bhk,bhk->bh", r, u[None] * k)[..., None] * v
    s_new = w[..., None] * cache_s + k[..., None] * v[:, :, None]
    y = R._group_norm(y[:, None], p["ln_x_scale"], cfg.norm_eps)[:, 0]
    out = (y.reshape(b, 1, d).to(x.dtype) * g) @ p["wo"]
    return out, s_new, x


def decode_block(kind, p, cache, x, cfg, pos: int, enc=None):
    """One block at one position; `cache` is this layer's (unstacked) view,
    updated in place."""
    if kind in ("attn", "moe_attn", "attn_local", "rglru_attn", "xattn"):
        window = cfg.window if kind in ("attn_local", "rglru_attn") else None
        a = _decode_gqa(p, cache, M._norm(p, "ln1", x, cfg), cfg, pos,
                        window=window)
        if cfg.post_norms:
            a = M._norm(p, "ln1_post", a, cfg)
        x = x + a
        if kind == "xattn":
            h = M._norm(p, "ln3", x, cfg)
            b = x.shape[0]
            hh, dh = cfg.n_heads, cfg.head_dim
            q = L.split_dims(h @ p["xq"], b, 1, hh, dh)
            mask = torch.ones((b, cache["xk"].shape[1]), dtype=torch.bool,
                              device=x.device)
            o = _attend_cache(q, cache["xk"], cache["xv"], mask,
                              1.0 / np.sqrt(dh), None)
            x = x + o @ p["xo"]
        h = M._norm(p, "ln2", x, cfg)
        m = L.moe_mlp(p["moe"], h, cfg) if kind == "moe_attn" \
            else L.glu_mlp(p, h, cfg)
        if cfg.post_norms:
            m = M._norm(p, "ln2_post", m, cfg)
        return x + m
    if kind in ("mla", "mla_dense"):
        x = x + _decode_mla(p, cache, M._norm(p, "ln1", x, cfg), cfg, pos)
        h = M._norm(p, "ln2", x, cfg)
        m = L.moe_mlp(p["moe"], h, cfg) if kind == "mla" \
            else L.glu_mlp(p, h, cfg)
        return x + m
    if kind == "rwkv":
        h = M._norm(p, "ln1", x, cfg)
        tm, s_new, prev_tm = _decode_rwkv_tm(p, cache["s"], cache["prev_tm"],
                                             h, cfg)
        x = x + tm
        h2 = M._norm(p, "ln2", x, cfg)
        cm, prev_ch = R.rwkv_channel_mix(p, h2, cfg, prev=cache["prev_ch"])
        cache["s"].copy_(s_new)
        cache["prev_tm"].copy_(prev_tm)
        cache["prev_ch"].copy_(prev_ch)
        return x + cm
    if kind == "rglru":
        h = M._norm(p, "ln1", x, cfg)
        rec, (tail, hstate) = R.rg_lru(p, h, cfg,
                                       state=(cache["tail"], cache["h"]))
        cache["tail"].copy_(tail)
        cache["h"].copy_(hstate)
        x = x + rec
        return x + L.glu_mlp(p, M._norm(p, "ln2", x, cfg), cfg)
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# serve_step: one new token for the whole stack
# ---------------------------------------------------------------------------

@torch.no_grad()
def serve_step(params, cfg: ModelConfig, cache: list, token: torch.Tensor,
               pos: int):
    """token (B,1) int, pos int -> (logits (B, Vp) f32, cache): the cache
    is updated in place and returned."""
    x = M.embed_tokens(params, token, cfg)
    for grp, gp, gc in zip(cfg.groups, params["groups"], cache):
        for up, uc in zip(M.unstack(gp), M.unstack(gc)):
            for bi, kind in enumerate(grp.unit):
                x = decode_block(kind, up[f"b{bi}"], uc[f"b{bi}"], x, cfg,
                                 pos)
            x = M._pin_batch(x, cfg)
    h = M._norm(params, "final_norm", x, cfg)
    logits = (h[:, 0].to(BF16) @ params["head"]).to(F32)
    logits = L.softcap(logits, cfg.final_softcap)
    return logits, cache
