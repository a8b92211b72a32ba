"""Transformer layers: norms, RoPE, GQA/MLA attention (flash-chunked causal,
banded local, softcap), dense GLU MLP, and sort-based sparse MoE.

All compute is dtype-explicit, as in the JAX package: bf16 matmuls, f32
softmax, norms and router. Attention never materializes the full (S, S)
score matrix: an online softmax over KV chunks, with chunks that are all
future or all outside the window skipped before any work.

The MoE dispatch is the paper's sparsity idea applied to the LM substrate
(DESIGN.md §5): assignment one-hots are never multiplied as dense matrices;
tokens are sorted by expert id and gathered into (E, C, D), so compute and
traffic follow the routed tokens. Both the dispatch and the combine are
gathers whose backward is a gather too (`_GatherRows`): no scatter-add
runs in either direction, so a step is deterministic on the card.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import tp as T

BF16 = torch.bfloat16
F32 = torch.float32


# ---------------------------------------------------------------------------
# norms / rope / activations
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(F32)
    y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (y * (1.0 + scale.to(F32))).to(x.dtype)


def rope_freqs(positions: torch.Tensor, dim: int, theta: float) -> tuple:
    """positions: (...,) int -> cos/sin (..., dim/2) f32."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=F32,
                                        device=positions.device) / dim))
    ang = positions.to(F32)[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (..., T, H, D); cos/sin: (..., T, D/2) broadcast over heads."""
    xf = x.to(F32)
    x1, x2 = xf[..., ::2], xf[..., 1::2]
    c, s = cos[..., None, :], sin[..., None, :]
    out = torch.stack([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


def _gelu(v: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu's default is the tanh approximation
    return F.gelu(v, approximate="tanh")


def _relu_sq(v: torch.Tensor) -> torch.Tensor:
    return torch.square(F.relu(v))


_ACTS = {"silu": F.silu, "gelu": _gelu, "relu_sq": _relu_sq}


def act_fn(name: str):
    return _ACTS[name]


def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return x
    return torch.tanh(x / cap) * cap


# ---------------------------------------------------------------------------
# flash-chunked attention (causal / banded-local), GQA
# ---------------------------------------------------------------------------

def split_dims(x: torch.Tensor, *shape: int) -> torch.Tensor:
    """x.reshape(shape) for a reshape that splits a dim of x (heads out of
    a projection's width, KV groups out of the heads). A DTensor sharded on
    the dim the reshape splits, over more devices than its first new dim
    divides into (8 KV heads over 16), is gathered on that dim first:
    DTensor cannot split it, where the JAX package's partitioner tiles the
    split. A plain tensor is reshaped as it is."""
    if type(x) is torch.Tensor:
        return x.reshape(shape)
    j = next((i for i, (a, b) in enumerate(zip(x.shape, shape))
              if a != b), None)
    if j is not None:
        x = _gather_undivided(x, j, shape[j])
    return x.reshape(shape)


def merge_dims(x: torch.Tensor, *shape: int) -> torch.Tensor:
    """x.reshape(shape) for a reshape that merges dims of x (heads into a
    width, KV groups into the heads). Its backward splits the gradient's
    merged dim: a DTensor gradient sharded there over more devices than
    the first merged dim divides into (24 heads over 16) is gathered on
    that dim first, as `split_dims` does going forward. A plain tensor is
    reshaped as it is."""
    y = x.reshape(shape)
    if type(x) is torch.Tensor:
        return y
    j = next((i for i, (a, b) in enumerate(zip(x.shape, shape))
              if a != b), None)
    return y if j is None else _SplitGrad.apply(y, j, x.shape[j])


class _SplitGrad(torch.autograd.Function):
    """The identity, whose backward gathers the gradient's dim `j` where
    its shards do not divide `lead` (`merge_dims`)."""

    @staticmethod
    def forward(ctx, y, j, lead):
        ctx.j, ctx.lead = j, lead
        return y.view_as(y)

    @staticmethod
    def backward(ctx, dy):
        return _gather_undivided(dy, ctx.j, ctx.lead), None, None


def _gather_undivided(x: torch.Tensor, j: int, lead: int) -> torch.Tensor:
    """A DTensor x replicated on dim j where the devices its shards span
    do not divide `lead`; anything else as it is."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(x, DTensor):
        return x
    mesh, pl = x.device_mesh, list(x.placements)
    on_j = [i for i, q in enumerate(pl) if isinstance(q, Shard) and q.dim == j]
    ways = 1
    for i in on_j:
        ways *= mesh.size(i)
    if lead % ways == 0:
        return x
    for i in on_j:
        pl[i] = Replicate()
    return x.redistribute(mesh, pl)


def _attn_chunk(q, k, v, mask, scale, cap):
    """q (B,Tq,H,Dk) k (B,Tk,Hkv,Dk) v (B,Tk,Hkv,Dv) mask (Tq,Tk)."""
    b, tq, h, dk = q.shape
    hkv = k.shape[2]
    g = h // hkv
    qf = split_dims(q.to(F32), b, tq, hkv, g, dk)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.to(F32)) * scale
    s = softcap(s, cap)
    s = torch.where(mask[None, None, None], s, -1e30)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.to(F32))
    return m, l, o  # o: (b, tq, hkv, g, dv)


def flash_attention(q, k, v, *, causal: bool, window: int | None,
                    scale: float, cap: float | None,
                    q_offset: int = 0, kv_chunk: int = 2048,
                    q_chunk: int = 2048) -> torch.Tensor:
    """Online-softmax attention over KV chunks. q (B,Tq,H,D), k/v (B,Tk,Hkv,D).
    `q_offset` is the absolute position of q[0] relative to k[0]. Full
    (Tq,Tk) scores never materialize.

    Long queries are processed in q_chunk slices so the static causal/window
    chunk-skip below turns causal attention into ~T^2/2 and windowed local
    attention into O(T*window) actual compute."""
    if q.shape[1] > q_chunk:
        outs = [flash_attention(q[:, i:i + q_chunk], k, v, causal=causal,
                                window=window, scale=scale, cap=cap,
                                q_offset=q_offset + i, kv_chunk=kv_chunk,
                                q_chunk=q_chunk)
                for i in range(0, q.shape[1], q_chunk)]
        return torch.cat(outs, dim=1)
    b, tq, h, dk = q.shape
    tk = k.shape[1]
    hkv = k.shape[2]
    dv = v.shape[3]
    g = h // hkv
    dev = q.device
    kv_chunk = min(kv_chunk, tk)
    n_chunks = -(-tk // kv_chunk)
    pad = n_chunks * kv_chunk - tk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    q_pos = q_offset + torch.arange(tq, device=dev)

    # unrolled over KV chunks: chunks whose mask is statically all-False
    # (future-of-causal / outside-window) are skipped entirely
    m_run = torch.full((b, hkv, g, tq), -torch.inf, dtype=F32, device=dev)
    l_run = torch.zeros((b, hkv, g, tq), dtype=F32, device=dev)
    o_run = torch.zeros((b, hkv, g, tq, dv), dtype=F32, device=dev)
    q_lo, q_hi = q_offset, q_offset + tq - 1
    for ci in range(n_chunks):
        k_lo, k_hi = ci * kv_chunk, ci * kv_chunk + kv_chunk - 1
        if causal and k_lo > q_hi:
            continue                          # chunk entirely in the future
        if window is not None and k_hi <= q_lo - window:
            continue                          # chunk entirely out of window
        k_pos = k_lo + torch.arange(kv_chunk, device=dev)
        mask = (k_pos < tk)[None, :].expand(tq, kv_chunk)
        if causal:
            mask = mask & (k_pos[None, :] <= q_pos[:, None])
        if window is not None:
            mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
        m_c, l_c, o_c = _attn_chunk(q, k[:, k_lo:k_lo + kv_chunk],
                                    v[:, k_lo:k_lo + kv_chunk], mask, scale,
                                    cap)
        o_c = o_c.permute(0, 2, 3, 1, 4)        # (b, hkv, g, tq, dv)
        m_new = torch.maximum(m_run, m_c)
        a = torch.exp(m_run - m_new)
        bb = torch.exp(m_c - m_new)
        l_run = l_run * a + l_c * bb
        o_run = o_run * a[..., None] + o_c * bb[..., None]
        m_run = m_new
    o = o_run / torch.clamp(l_run, min=1e-30)[..., None]
    out = merge_dims(o.permute(0, 3, 1, 2, 4), b, tq, h, dv)
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# GQA attention block
# ---------------------------------------------------------------------------

def _kv_heads(tp: T.Plain, h: int, hkv: int):
    """How this rank's KV heads come: "shard" (hkv divides the 'model'
    ways: each rank projects its own), "slice" (the ways divide by hkv:
    the rank's query heads share one KV head, projected from the weight
    gathered whole and sliced), or None (the query-sequence split)."""
    if h % tp.ways:
        return None
    if hkv % tp.ways == 0:
        return "shard"
    if tp.ways % hkv == 0:
        return "slice"
    return None


def attention(p: dict, x: torch.Tensor, cfg: ModelConfig, *, causal: bool,
              window: int | None, positions: torch.Tensor) -> torch.Tensor:
    """x (B,T,D) -> (B,T,D). p: wq (D,H*Dh), wk/wv (D,Hkv*Dh), wo (H*Dh,D)."""
    return _attention(p, x, x, cfg, causal=causal, window=window,
                      cap=cfg.attn_softcap, positions=positions)


def cross_attention(p: dict, x: torch.Tensor, enc: torch.Tensor,
                    cfg: ModelConfig) -> torch.Tensor:
    return _attention(p, x, enc, cfg, causal=False, window=None, cap=None,
                      positions=None)


def _attention(p: dict, x, src, cfg: ModelConfig, *, causal: bool,
               window: int | None, cap: float | None,
               positions: torch.Tensor | None) -> torch.Tensor:
    """GQA attention: x (B,T,D) queries, src (B,S,D) keys and values (x
    itself, or the encoder output), rotated by `positions` unless None. A
    DTensor step in the 2D mode runs it as a tensor-parallel region: heads
    that divide the 'model' ways column-parallel (each rank its heads and
    their KV heads, `_kv_heads`) into a row-parallel `wo`, other heads by
    the query-sequence split (`_attention_rows`)."""
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    tp = T.region(x, cfg)
    how = _kv_heads(tp, h, hkv)
    if how is None:
        if tp.splits_rows(x.shape[1]) and tp.splits_rows(src.shape[1]):
            return _attention_rows(tp, p, x, src, cfg, causal=causal,
                                   window=window, cap=cap,
                                   positions=positions)
        tp, how = T.PLAIN, "shard"
    xl = tp.enter(x)
    sl = xl if src is x else tp.enter(src)
    b, t, _ = xl.shape
    s = sl.shape[1]
    hl = h // tp.ways
    if how == "shard":
        hkvl, wk, wv = hkv // tp.ways, tp.column(p["wk"]), tp.column(p["wv"])
    else:
        j = tp.rank * hl // (h // hkv)          # the KV head of its group
        cols = slice(j * dh, (j + 1) * dh)
        hkvl = 1
        wk, wv = tp.whole(p["wk"])[:, cols], tp.whole(p["wv"])[:, cols]
    q = split_dims(xl @ tp.column(p["wq"]), b, t, hl, dh)
    k = split_dims(sl @ wk, b, s, hkvl, dh)
    v = split_dims(sl @ wv, b, s, hkvl, dh)
    if positions is not None:
        cos, sin = rope_freqs(positions, dh, cfg.rope_theta)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    o = flash_attention(q, k, v, causal=causal, window=window,
                        scale=1.0 / np.sqrt(dh), cap=cap)
    return tp.exit_sum(merge_dims(o, b, t, hl * dh) @ tp.row(p["wo"]))


def _attention_rows(tp: T.Region, p: dict, x, src, cfg: ModelConfig, *,
                    causal: bool, window: int | None, cap: float | None,
                    positions: torch.Tensor | None) -> torch.Tensor:
    """`_attention` by the query-sequence split: each rank attends its two
    blocks of the query sequence (`Region.rows`) with `wq`/`wo` whole and
    K/V projected on its rows and all-gathered."""
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    xl = tp.enter(x)
    sl = xl if src is x else tp.enter(src)
    b, t, _ = xl.shape
    c, starts = tp.blocks(t)
    xq = tp.rows(xl)
    sq = xq if src is x else tp.rows(sl)
    q = (xq @ tp.whole(p["wq"])).reshape(b, 2 * c, h, dh)
    k = (sq @ tp.whole(p["wk"])).reshape(b, -1, hkv, dh)
    v = (sq @ tp.whole(p["wv"])).reshape(b, -1, hkv, dh)
    if positions is not None:
        cos, sin = rope_freqs(tp.rows(positions[None])[0], dh, cfg.rope_theta)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    k, v = tp.gather_rows(k), tp.gather_rows(v)
    o = torch.cat([flash_attention(q[:, i * c:(i + 1) * c], k, v,
                                   causal=causal, window=window,
                                   scale=1.0 / np.sqrt(dh), cap=cap,
                                   q_offset=start)
                   for i, start in enumerate(starts)], 1)
    return tp.exit_rows(o.reshape(b, 2 * c, h * dh) @ tp.whole(p["wo"]))


def mla_attention(p: dict, x: torch.Tensor, cfg: ModelConfig,
                  positions: torch.Tensor) -> torch.Tensor:
    """DeepSeek-V2 Multi-head Latent Attention (training/prefill form).

    KV compressed to kv_lora (+ shared rope key); decode uses the absorbed
    form over the compressed cache (serving/decode.py). A DTensor step in
    the 2D mode runs it as a tensor-parallel region: the two
    down-projections column-parallel and all-gathered (their norms need
    whole rows), the up-projections column-parallel over this rank's heads,
    `wo` row-parallel."""
    tp = T.region(x, cfg, cfg.n_heads, cfg.q_lora,
                  cfg.kv_lora + cfg.rope_head_dim)
    x = tp.enter(x)
    b, t, _ = x.shape
    h = cfg.n_heads // tp.ways
    dn, dr, dv = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    cq = rms_norm(tp.gather(x @ tp.column(p["wq_a"]), 2),
                  tp.whole(p["q_norm"]), cfg.norm_eps)
    q = split_dims(cq @ tp.column(p["wq_b"]), b, t, h, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    ckv_full = tp.gather(x @ tp.column(p["wkv_a"]), 2)  # (B,T,kv_lora+dr)
    ckv = rms_norm(ckv_full[..., :cfg.kv_lora], tp.whole(p["kv_norm"]),
                   cfg.norm_eps)
    k_rope = split_dims(ckv_full[..., cfg.kv_lora:], b, t, 1, dr)
    kv = split_dims(ckv @ tp.column(p["wkv_b"]), b, t, h, dn + dv)
    k_nope, v = kv[..., :dn], kv[..., dn:]
    cos, sin = rope_freqs(positions, dr, cfg.rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)
    k_rope = apply_rope(k_rope, cos, sin).expand(b, t, h, dr)
    q_full = torch.cat([q_nope, q_rope], -1)
    k_full = torch.cat([k_nope, k_rope], -1)
    o = flash_attention(q_full, k_full, v, causal=True, window=None,
                        scale=1.0 / np.sqrt(dn + dr), cap=None)
    return tp.exit_sum(merge_dims(o, b, t, h * dv) @ tp.row(p["wo"]))


# ---------------------------------------------------------------------------
# dense GLU MLP
# ---------------------------------------------------------------------------

def glu_mlp(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """A DTensor step in the 2D mode runs it as a tensor-parallel region:
    w_gate and w_up column-parallel, w_down row-parallel."""
    tp = T.region(x, cfg, p["w_gate"].shape[-1])
    x = tp.enter(x)
    g = act_fn(cfg.act)(x @ tp.column(p["w_gate"]))
    return tp.exit_sum((g * (x @ tp.column(p["w_up"]))) @ tp.row(p["w_down"]))


# ---------------------------------------------------------------------------
# MoE with sort-based (sparsity-exploiting) dispatch
# ---------------------------------------------------------------------------

class _GatherRows(torch.autograd.Function):
    """y[g, i] = x[g, fwd[g, i]] with row N of x (N rows) read as zeros.

    `bwd[g, j, :]` lists the rows of y that copied x[g, j] (row M of y, M
    rows, stands for "none"), so the backward is a gather and a sum over
    the last index: dx[g, j] = sum_k dy[g, bwd[g, j, k]]. Autograd's own
    backward of a gather is a scatter-add, whose float sums run in atomic
    order on the card."""

    @staticmethod
    def forward(ctx, x, fwd, bwd):
        g, n, d = x.shape
        m = fwd.shape[1]
        ctx.save_for_backward(bwd)
        ctx.m = m
        xp = torch.cat([x, x.new_zeros(g, 1, d)], 1).reshape(g * (n + 1), d)
        off = torch.arange(g, device=x.device)[:, None] * (n + 1)
        return xp.index_select(0, (fwd + off).reshape(-1)).reshape(g, m, d)

    @staticmethod
    def backward(ctx, dy):
        (bwd,) = ctx.saved_tensors
        g, n, k = bwd.shape
        m, d = ctx.m, dy.shape[-1]
        dyp = torch.cat([dy, dy.new_zeros(g, 1, d)], 1).reshape(
            g * (m + 1), d)
        off = torch.arange(g, device=dy.device)[:, None, None] * (m + 1)
        rows = dyp.index_select(0, (bwd + off).reshape(-1))
        return rows.reshape(g, n, k, d).sum(2), None, None


def moe_mlp(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x (B,T,D) -> (B,T,D). Router f32; tokens sorted by expert id and
    gathered to (E, C, D); capacity drops overflow (cap_factor).

    moe_dispatch='global' sorts all B*T tokens at once; 'per_example' runs
    the dispatch per sequence (one batched sort), with capacity budgeted
    per sequence."""
    b, t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    if cfg.moe_dispatch == "per_example":
        cap = max(1, int(np.ceil(t * k / e * cfg.capacity_factor)))
        out = _moe_tokens(p, x, cfg, cap)
    else:
        n = b * t
        cap = max(1, int(np.ceil(n * k / e * cfg.capacity_factor)))
        out = _moe_tokens(p, x.reshape(1, n, d), cfg, cap).reshape(b, t, d)
    if cfg.n_shared_experts:
        out = out + glu_mlp(p["shared"], x, cfg)
    return out


def _router(p: dict, xf: torch.Tensor, cfg: ModelConfig):
    """-> (gate, ids), each (G, N, K): the top_k experts of each token,
    ties to the lower expert id (as jax.lax.top_k), and their renormalized
    probabilities times router_scale. A DTensor step in the 2D mode whose
    blocks G split over the batch axes (the 'per_example' dispatch)
    computes the logits on this rank's span of the N tokens, all-gathered
    over 'model'."""
    tp = T.region(xf, cfg, xf.shape[1])
    if xf.shape[0] % tp.batch_ways:
        tp = T.PLAIN
    logits = tp.exit_gather(tp.own(tp.enter(xf), 1).to(F32)
                            @ tp.whole(p["router"]).to(F32), 1)   # (G,N,E)
    probs = torch.softmax(logits, -1)
    # a stable descending sort keeps equal probabilities in expert order
    srt, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, ids = srt[..., :cfg.top_k], ids[..., :cfg.top_k]
    gate = (gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
            ) * cfg.router_scale
    return gate, ids


def _whole(t: torch.Tensor) -> torch.Tensor:
    """A DTensor gathered into the whole tensor (a plain one on every
    device); a plain tensor as it is. The dispatch's index bookkeeping
    (sort, searchsorted, scatter) has no DTensor sharding strategy, and a
    sort over all tokens needs all of them, as the JAX package's
    partitioner gathers them too."""
    if type(t) is torch.Tensor:
        return t
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def _expert_ffn(p: dict, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The experts' GLU on dispatched tokens h (G, E, C, D) -> (G, E, C, D).

    A DTensor step runs it expert-parallel on the local shards: h is laid
    out with G over the activation batch axes (`cfg.act_axes`), or its
    slots C where G does not divide (the 'global' dispatch's one block),
    and E over 'model' (unless the batch took it) where they divide, each
    weight is gathered to whole experts sharded as E is, and the einsums
    run on the local tensors. The weights' gradients are partial sums over
    the batch axes, reduced to their own layout by DTensor. Left to
    DTensor's own einsum strategies the step kept every block and expert
    on each device, then viewed a local shard by permuted global strides,
    which failed."""
    w = (p["w_gate"], p["w_up"], p["w_down"])
    if type(h) is torch.Tensor:
        return _glu_experts(h, *w, cfg.act)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    if not isinstance(h, DTensor):
        return _glu_experts(h, *w, cfg.act)
    mesh = h.device_mesh
    names = tuple(mesh.mesh_dim_names)
    n_g = 1
    for a in cfg.act_axes:
        n_g *= mesh.size(names.index(a))
    g_on = set(cfg.act_axes) if cfg.act_axes and h.shape[0] % n_g == 0 \
        else set()
    # one block of every token (the 'global' dispatch): its slots over the
    # batch axes instead, so no device repeats another's
    c_on = set(cfg.act_axes) if cfg.act_axes and not g_on \
        and h.shape[2] % n_g == 0 else set()
    # experts over 'model' unless the batch took it (pure FSDP)
    e_on = {"model"} if "model" in names and "model" not in g_on | c_on \
        and h.shape[1] % mesh.size(names.index("model")) == 0 else set()
    h_pl = [Shard(0) if a in g_on else Shard(2) if a in c_on
            else Shard(1) if a in e_on else Replicate() for a in names]
    w_pl = [Shard(0) if a in e_on else Replicate() for a in names]
    w_grad = [Partial() if a in g_on | c_on else q
              for a, q in zip(names, w_pl)]
    hl = h.redistribute(mesh, h_pl).to_local()
    wl = [x.redistribute(mesh, w_pl).to_local(grad_placements=w_grad)
          for x in w]
    # the einsums leave their result experts-major; the DTensor is
    # described row-major, and DTensor views the local tensor by that
    out = _glu_experts(hl, *wl, cfg.act).contiguous()
    out = DTensor.from_local(out, mesh, h_pl, shape=h.shape,
                             stride=h.stride())
    if c_on:
        # the combine flattens (E, C); DTensor (torch 2.11) cannot flatten
        # a split C behind E, so the slots are gathered first
        out = out.redistribute(mesh, [Replicate() if a in c_on else q
                                      for a, q in zip(names, h_pl)])
    return out


def _glu_experts(h, w_gate, w_up, w_down, act: str) -> torch.Tensor:
    gh = act_fn(act)(torch.einsum("gecd,edf->gecf", h, w_gate))
    uh = torch.einsum("gecd,edf->gecf", h, w_up)
    return torch.einsum("gecf,efd->gecd", gh * uh, w_down)


def _moe_tokens(p: dict, xf: torch.Tensor, cfg: ModelConfig,
                cap: int) -> torch.Tensor:
    """Sort-based dispatch of G independent (N, D) token blocks, batched:
    xf (G, N, D) -> (G, N, D)."""
    g, n, d = xf.shape
    e, k = cfg.n_experts, cfg.top_k
    ep = p["w_gate"].shape[-3]           # padded expert count (EP-divisible)
    dev = xf.device
    gate, ids = _router(p, xf, cfg)
    ids_f = _whole(ids.reshape(g, n * k))                      # (G, N*K)
    order = torch.argsort(ids_f, dim=-1, stable=True)
    ids_s = torch.gather(ids_f, 1, order)
    tok_s = torch.div(order, k, rounding_mode="floor")         # token of entry
    # position of each routed token inside its expert's queue
    same = torch.arange(n * k, device=dev).expand(g, n * k)
    seg_start = torch.searchsorted(
        ids_s, torch.arange(e, device=dev).expand(g, e).contiguous())
    pos = same - torch.gather(seg_start, 1, ids_s)
    keep = pos < cap
    slots = ep * cap
    dest = torch.where(keep, ids_s * cap + pos, slots)         # overflow slot
    # slot -> token (n: an empty slot, read as zeros); dropped entries land
    # in a discard area of their own, so no two writes share an index
    slot_tok = torch.full((g, slots + n * k), n, dtype=torch.long,
                          device=dev)
    slot_tok.scatter_(1, torch.where(keep, dest, slots + same), tok_s)
    slot_tok = slot_tok[:, :slots]
    # entry (token, j) -> slot, in token order (slots: dropped)
    entry_slot = torch.empty_like(dest).scatter_(1, order, dest)
    # slot -> entry (n*k: an empty slot)
    slot_entry = torch.full((g, slots + n * k), n * k, dtype=torch.long,
                            device=dev)
    slot_entry.scatter_(1, torch.where(keep, dest, slots + same), order)
    slot_entry = slot_entry[:, :slots]

    h = _GatherRows.apply(xf, slot_tok, entry_slot.reshape(g, n, k))
    h = h.reshape(g, ep, cap, d)
    # expert FFN: (E,C,D) x (E,D,F); pad experts (>= e) receive no tokens,
    # only the zero rows
    oh = _expert_ffn(p, h, cfg)
    contrib = _GatherRows.apply(oh.reshape(g, slots, d), entry_slot,
                                slot_entry[..., None])        # (G, N*K, D)
    contrib = contrib * gate.reshape(g, n * k)[..., None].to(xf.dtype)
    return contrib.reshape(g, n, k, d).sum(2)
