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
from repro_torch.models import tp as T

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


def _decay(p: dict, xm: torch.Tensor, tp: T.Plain = T.PLAIN) -> torch.Tensor:
    """Finch's data-dependent decay, f32 in (0.135, 1): w from a small LoRA
    on the shifted input, raw clipped so per-step log-decay >= -2 (keeps
    the chunk-factored exponents, <= chunk*2 = 64, inside f32 range). In
    a region the LoRA runs row-parallel into a small all-reduce, then
    column-parallel."""
    lora = tp.all_sum(tp.own(xm, -1).to(F32) @ tp.row(p["w_lora_a"]),
                      partial_grad=True)
    raw = torch.clamp(tp.column(p["w_base"]).to(F32)
                      + lora @ tp.column(p["w_lora_b"]),
                      -8.0, 0.6931)
    return torch.exp(-torch.exp(raw))


def rwkv_time_mix(p: dict, x: torch.Tensor, cfg: ModelConfig,
                  state: tuple | None = None, chunk: int = 32):
    """x (B,T,D) -> (B,T,D), carrying (shift_prev, S) state for decode.

    A DTensor step in the 2D mode (with no state) runs it as a
    tensor-parallel region over this rank's channels of D. Where the heads
    divide the 'model' ways, those are whole heads: r, k, v, g and the
    decay column-parallel, the scan and its norm local, `wo` row-parallel.
    Where the ways divide by the heads, the rank's channels are a slice of
    one head's key channels: the scan's sums over them are partial sums
    (v, the head's whole values, projected from `wv` gathered whole), so
    y is all-reduced, normed whole and sliced back to the rank's
    channels."""
    d = x.shape[-1]
    dh = cfg.rwkv_head_dim
    h = d // dh
    tp = T.region(x, cfg, d) if state is None else T.PLAIN
    if h % tp.ways and tp.ways % h:
        tp = T.PLAIN
    heads = h % tp.ways == 0
    hl = h // tp.ways if heads else 1
    dk = d // tp.ways // hl
    x = tp.enter(x)
    b, t, _ = x.shape
    prev_tok = state[0] if state is not None else None
    xm = _token_shift(x, tp.whole(p["mix_rkvw"]), prev_tok)
    r = L.split_dims(xm @ tp.column(p["wr"]), b, t, hl, dk)
    k = L.split_dims(xm @ tp.column(p["wk"]), b, t, hl, dk)
    if heads:
        v = L.split_dims(xm @ tp.column(p["wv"]), b, t, hl, dh)
    else:
        hd = tp.rank * h // tp.ways                 # the head of its channels
        v = (xm @ tp.whole(p["wv"])[:, hd * dh:(hd + 1) * dh]).reshape(
            b, t, 1, dh)
    g = F.silu(xm @ tp.column(p["wg"]))
    w = L.split_dims(_decay(p, xm, tp), b, t, hl, dk)
    u = tp.column(p["u_bonus"]).reshape(hl, dk).to(F32)

    s = state[1] if state is not None else torch.zeros(
        (b, hl, dk, dh), dtype=F32, device=x.device)
    y, s = _wkv(r, k, v, w, u, s, chunk)
    if heads:
        y = _group_norm(y, tp.shard(p["ln_x_scale"], 0),
                        cfg.norm_eps).reshape(b, t, hl * dh)
    else:
        y = tp.all_sum(F.pad(y, (0, 0, hd, h - 1 - hd)), partial_grad=True)
        y = tp.own(_group_norm(y, tp.whole(p["ln_x_scale"]),
                               cfg.norm_eps).reshape(b, t, d), -1)
    out = tp.exit_sum((y.to(x.dtype) * g.to(x.dtype)) @ tp.row(p["wo"]))
    # a region carries no state (its views would hold the local tensors)
    return out, ((x[:, -1:], s) if tp is T.PLAIN else None)


def _wkv(r, k, v, w, u, s, chunk: int) -> tuple:
    """The chunked WKV scan: r, k, w (B,T,H,Dk), v (B,T,H,Dv), u (H,Dk),
    state s (B,H,Dk,Dv) -> (y (B,T,H,Dv), the last state)."""
    b, t, h, dk = r.shape
    dv = v.shape[-1]
    tc = min(chunk, t)
    n_chunks = -(-t // tc)
    pad = n_chunks * tc - t
    if pad:
        r, k, v = (F.pad(z, (0, 0, 0, 0, 0, pad)) for z in (r, k, v))
        w = F.pad(w, (0, 0, 0, 0, 0, pad), value=1.0)

    def split(z):  # (B, T, H, Dh) -> (Nc, B, H, Tc, Dh)
        return z.reshape(b, n_chunks, tc, h, z.shape[-1]).permute(
            1, 0, 3, 2, 4)

    rc, kc, vc, wc = split(r.to(F32)), split(k.to(F32)), \
        split(v.to(F32)), split(w)
    mask = torch.tril(torch.ones((tc, tc), dtype=torch.bool,
                                 device=r.device), diagonal=-1)
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
        b, n_chunks * tc, h, dv)[:, :t]
    return y, s


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
    """A DTensor step in the 2D mode runs it as a tensor-parallel region,
    with no state: wk_ch column-parallel into a row-parallel wv_ch, whose
    sum is reduce-scattered over D to meet this rank's columns of the
    wr_ch gate, and the product all-gathered."""
    tp = T.region(x, cfg, cfg.d_ff, cfg.d_model) if prev is None \
        else T.PLAIN
    x = tp.enter(x)
    xm = _token_shift(x, tp.whole(p["mix_ch"]), prev)
    k = torch.square(F.relu(xm @ tp.column(p["wk_ch"])))
    out = torch.sigmoid(xm @ tp.column(p["wr_ch"])) \
        * tp.scatter(k @ tp.row(p["wv_ch"]), 2)
    return tp.exit_gather(out, 2), (x[:, -1:] if tp is T.PLAIN else None)


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
    x (B,T,D) -> (B,T,D); state = (conv_tail, h_last) for decode.

    A DTensor step in the 2D mode (with no state) runs it as a
    tensor-parallel region over this rank's channels of the LRU width: the
    branch and input projections column-parallel, the conv, gates' bias
    and scan on its channels; the gates' (W, W) products take the conv
    output all-gathered whole into their column-parallel weights; `w_out`
    row-parallel."""
    w = cfg.lru_width or x.shape[-1]
    tp = T.region(x, cfg, w) if state is None else T.PLAIN
    x = tp.enter(x)
    b, t, _ = x.shape
    wl = w // tp.ways
    gate = F.gelu(x @ tp.column(p["w_gate_branch"]),
                  approximate="tanh")                   # jax's gelu
    y = x @ tp.column(p["w_in"])                        # (B,T,W)
    # depthwise causal conv, width cw
    cw = cfg.conv_width
    tail = state[0] if state is not None else torch.zeros(
        (b, cw - 1, wl), dtype=x.dtype, device=x.device)
    ypad = torch.cat([tail, y], dim=1)
    kernel = tp.column(p["conv_w"]).to(F32)             # (cw, W)
    yc = sum(ypad[:, i:i + t].to(F32) * kernel[i][None, None]
             for i in range(cw)).to(x.dtype) + tp.column(p["conv_b"]).to(
        x.dtype)
    # RG-LRU gates
    yw = tp.gather(yc, 2)
    rg = torch.sigmoid(yw.to(F32) @ tp.column(p["w_rg"]).to(F32)
                       + tp.column(p["b_rg"]))
    ig = torch.sigmoid(yw.to(F32) @ tp.column(p["w_ig"]).to(F32)
                       + tp.column(p["b_ig"]))
    log_a = -RG_LRU_C * F.softplus(tp.column(p["lambda"]).to(F32)) * rg
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * (ig * yc.to(F32))
    aa, bb = _linear_scan(a, gated)
    h = bb if state is None else aa * state[1][:, None] + bb   # (B,T,W)
    out = tp.exit_sum((h.to(x.dtype) * gate) @ tp.row(p["w_out"]))
    return out, ((ypad[:, t:], h[:, -1]) if tp is T.PLAIN else None)
