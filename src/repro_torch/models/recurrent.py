"""Attention-free recurrences: RWKV6 (Finch) and RG-LRU (Griffin /
RecurrentGemma). Both are O(T) in sequence length.

RWKV6 time-mix: per-head state S in R^{dk x dv} with data-dependent
per-channel decay w_t:   S_t = diag(w_t) S_{t-1} + k_t^T v_t,
                         y_t = r_t (S_{t-1} + diag(u) k_t^T v_t).
Implemented chunk-parallel: within a chunk the contributions are dense
matmuls against cumulative decay products; the state is carried across
chunks by a loop (sequential length T/chunk, as the reference's scan).

RG-LRU:  h_t = a_t . h_{t-1} + sqrt(1 - a_t^2) . (i_t . x_t),
         a_t = exp(-c * softplus(L) * sigmoid(r_t))
computed with a log-depth (Hillis-Steele) scan over the gated pairs.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

F32 = torch.float32
RG_LRU_C = 8.0


# ---------------------------------------------------------------------------
# RWKV6
# ---------------------------------------------------------------------------

def _token_shift(x: torch.Tensor, mix: torch.Tensor,
                 prev: torch.Tensor | None = None) -> torch.Tensor:
    """lerp(x, shift(x), mix); prev = last token of previous segment."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    xs = torch.cat([prev, x[:, :-1]], dim=1)
    return x + (xs - x) * mix.to(x.dtype)


def _decay(p: dict, xm: torch.Tensor) -> torch.Tensor:
    """Finch's data-dependent decay, f32 in (0.135, 1): w from a small LoRA
    on the shifted input, raw clipped so per-step log-decay >= -2 (keeps
    the chunk-factored exponents, <= chunk*2 = 64, inside f32 range)."""
    raw = torch.clamp(p["w_base"].to(F32)
                      + (xm.to(F32) @ p["w_lora_a"]) @ p["w_lora_b"],
                      -8.0, 0.6931)
    return torch.exp(-torch.exp(raw))


def rwkv_time_mix(p: dict, x: torch.Tensor, cfg: ModelConfig,
                  state: tuple | None = None, chunk: int = 32):
    """x (B,T,D) -> (B,T,D), carrying (shift_prev, S) state for decode."""
    b, t, d = x.shape
    dh = cfg.rwkv_head_dim
    h = d // dh
    prev_tok = state[0] if state is not None else None
    xm = _token_shift(x, p["mix_rkvw"], prev_tok)
    r = L.split_dims(xm @ p["wr"], b, t, h, dh)
    k = L.split_dims(xm @ p["wk"], b, t, h, dh)
    v = L.split_dims(xm @ p["wv"], b, t, h, dh)
    g = F.silu(xm @ p["wg"])
    w = L.split_dims(_decay(p, xm), b, t, h, dh)
    u = p["u_bonus"].reshape(h, dh).to(F32)

    s = state[1] if state is not None else torch.zeros(
        (b, h, dh, dh), dtype=F32, device=x.device)

    tc = min(chunk, t)
    n_chunks = -(-t // tc)
    pad = n_chunks * tc - t
    if pad:
        r, k, v = (F.pad(z, (0, 0, 0, 0, 0, pad)) for z in (r, k, v))
        w = F.pad(w, (0, 0, 0, 0, 0, pad), value=1.0)

    def split(z):  # (B, T, H, Dh) -> (Nc, B, H, Tc, Dh)
        return z.reshape(b, n_chunks, tc, h, dh).permute(1, 0, 3, 2, 4)

    rc, kc, vc, wc = split(r.to(F32)), split(k.to(F32)), \
        split(v.to(F32)), split(w)
    mask = torch.tril(torch.ones((tc, tc), dtype=torch.bool,
                                 device=x.device), diagonal=-1)
    ys = []
    for ci in range(n_chunks):
        rr, kk, vv, ww = rc[ci], kc[ci], vc[ci], wc[ci]   # (B,H,Tc,Dh)
        logw = torch.log(torch.clamp(ww, min=1e-38))
        cum = torch.cumsum(logw, dim=2)      # prod of decays up to t (incl)
        total = cum[:, :, -1:]
        # state contribution: decay from chunk start to t-1 (exclusive of t)
        dec_in = torch.exp(cum - logw)       # (B,H,Tc,Dh)
        y_state = torch.einsum("bhtk,bhkv->bhtv", rr * dec_in, s)
        # intra-chunk: sum_{j<t} r_t [prod_{s=j+1..t-1} w_s] k_j v_j
        att = torch.einsum("bhtk,bhjk->bhtj",
                           rr * torch.exp(cum - logw),
                           kk * torch.exp(-cum))
        att = torch.where(mask[None, None], att, 0.0)
        bonus = torch.einsum("bhtk,bhtk->bht", rr * u[None, :, None, :], kk)
        ys.append(y_state + torch.einsum("bhtj,bhjv->bhtv", att, vv)
                  + bonus[..., None] * vv)
        s = torch.exp(total).transpose(2, 3) * s + torch.einsum(
            "bhjk,bhjv->bhkv", kk * torch.exp(total - cum), vv)
    y = torch.stack(ys).permute(1, 0, 3, 2, 4).reshape(
        b, n_chunks * tc, h, dh)[:, :t]
    y = _group_norm(y, p["ln_x_scale"], cfg.norm_eps).reshape(b, t, d)
    out = (y.to(x.dtype) * g.to(x.dtype)) @ p["wo"]
    return out, (x[:, -1:], s)


def _group_norm(y: torch.Tensor, scale: torch.Tensor,
                eps: float) -> torch.Tensor:
    """Per-head LayerNorm on (B,T,H,Dh), population variance."""
    yf = y.to(F32)
    mu = yf.mean(-1, keepdim=True)
    var = yf.var(-1, keepdim=True, correction=0)
    return (yf - mu) * torch.rsqrt(var + eps) * scale.to(F32).reshape(
        1, 1, *scale.shape)


def rwkv_channel_mix(p: dict, x: torch.Tensor, cfg: ModelConfig,
                     prev: torch.Tensor | None = None):
    xm = _token_shift(x, p["mix_ch"], prev)
    k = torch.square(F.relu(xm @ p["wk_ch"]))
    out = torch.sigmoid(xm @ p["wr_ch"]) * (k @ p["wv_ch"])
    return out, x[:, -1:]


# ---------------------------------------------------------------------------
# RG-LRU (Griffin / RecurrentGemma recurrent block)
# ---------------------------------------------------------------------------

def _linear_scan(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """Inclusive scan of h_t = a_t h_{t-1} + b_t pairs along dim 1 in
    ceil(log2 T) doubling steps: (A, B) with h_t = A_t h_0 + B_t."""
    t = a.shape[1]
    step = 1
    while step < t:
        # (a, b)_t <- (a, b)_{t-step} then (a, b)_t: (a' a, b' a + b)
        hi = a[:, step:]
        b = torch.cat([b[:, :step], b[:, :-step] * hi + b[:, step:]], dim=1)
        a = torch.cat([a[:, :step], a[:, :-step] * hi], dim=1)
        step *= 2
    return a, b


def rg_lru(p: dict, x: torch.Tensor, cfg: ModelConfig,
           state: tuple | None = None):
    """Recurrent block: in-proj -> conv1d(4) -> RG-LRU -> gated out-proj.
    x (B,T,D) -> (B,T,D); state = (conv_tail, h_last) for decode."""
    b, t, d = x.shape
    w = cfg.lru_width or d
    gate = F.gelu(x @ p["w_gate_branch"], approximate="tanh")  # jax's gelu
    y = x @ p["w_in"]                                   # (B,T,W)
    # depthwise causal conv, width cw
    cw = cfg.conv_width
    tail = state[0] if state is not None else torch.zeros(
        (b, cw - 1, w), dtype=x.dtype, device=x.device)
    ypad = torch.cat([tail, y], dim=1)
    kernel = p["conv_w"].to(F32)                        # (cw, W)
    yc = sum(ypad[:, i:i + t].to(F32) * kernel[i][None, None]
             for i in range(cw)).to(x.dtype) + p["conv_b"].to(x.dtype)
    # RG-LRU gates
    rg = torch.sigmoid(yc.to(F32) @ p["w_rg"].to(F32) + p["b_rg"])
    ig = torch.sigmoid(yc.to(F32) @ p["w_ig"].to(F32) + p["b_ig"])
    log_a = -RG_LRU_C * F.softplus(p["lambda"].to(F32)) * rg
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * (ig * yc.to(F32))
    h0 = state[1] if state is not None else torch.zeros(
        (b, w), dtype=F32, device=x.device)
    aa, bb = _linear_scan(a, gated)
    h = aa * h0[:, None] + bb                           # (B,T,W)
    out = (h.to(x.dtype) * gate) @ p["w_out"]
    return out, (ypad[:, t:], h[:, -1])
