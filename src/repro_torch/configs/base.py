"""Model/arch configuration schema + registry for the assigned pool.

Every architecture is described as a sequence of *scan groups*: a unit
pattern of block kinds repeated R times; per-layer parameters are stacked
over the repeats and the forward loops over them, checkpointing each unit.

The fields, their order and defaults are the JAX package's, so `repr(cfg)`
and with it `checkpoint.store.config_fingerprint(cfg)` are the same in both
packages for every config.
"""
from __future__ import annotations

import dataclasses
from typing import Literal, Sequence

BlockKind = Literal[
    "attn",        # GQA self-attention + dense MLP
    "attn_local",  # windowed GQA + dense MLP
    "mla",         # DeepSeek multi-head latent attention + (shared+routed) MoE
    "mla_dense",   # MLA attention + dense MLP (DeepSeek first layer)
    "moe_attn",    # GQA attention + routed MoE MLP
    "rwkv",        # RWKV6 time-mix + channel-mix (attention-free)
    "rglru",       # RG-LRU recurrent block + dense MLP
    "rglru_attn",  # local attention block inside the Griffin pattern
]


@dataclasses.dataclass(frozen=True)
class ScanGroup:
    unit: tuple[BlockKind, ...]
    repeats: int


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    groups: tuple[ScanGroup, ...]
    d_head: int | None = None            # default d_model // n_heads

    # attention options
    rope_theta: float = 10000.0
    window: int = 4096                   # for *_local blocks
    attn_softcap: float | None = None    # gemma2
    final_softcap: float | None = None   # gemma2
    attn_bias: bool = False
    post_norms: bool = False             # gemma2 post-block norms

    # MLA (deepseek)
    q_lora: int = 0
    kv_lora: int = 0
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128

    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_ff_expert: int = 0
    d_ff_dense_first: int = 0            # deepseek layer-0 dense MLP width
    capacity_factor: float = 1.25
    router_scale: float = 1.0
    expert_pad_multiple: int = 16        # pad E for EP; 1 = no pad (then
                                         # experts shard d_model instead)
    moe_dispatch: str = "global"         # 'global': one sort over all
                                         # tokens (distributed sort under
                                         # pjit!); 'per_example': vmapped
                                         # per-sequence dispatch — sorts
                                         # stay shard-local (§Perf)

    # recurrent
    lru_width: int = 0                   # rg-lru
    conv_width: int = 4
    rwkv_head_dim: int = 64

    # embeddings / misc
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    act: Literal["silu", "gelu", "relu_sq"] = "silu"
    enc_dec: bool = False                # seamless
    n_enc_layers: int = 0
    frontend: Literal[None, "audio", "vlm"] = None
    n_patches: int = 576                 # vlm stub prefix length
    scale_embed: bool = False            # gemma-style sqrt(d) embed scaling
    sub_quadratic: bool = False          # may run the long_500k cell
    scan_unroll: bool = False            # unroll layer scans (roofline probes
                                         # only: XLA cost analysis counts
                                         # while bodies once)
    act_axes: tuple = ()                 # mesh axes pinning the activation
                                         # batch dim inside layer scans (set
                                         # by the launcher; empty = none)
    remat_policy: str = "none"           # 'none' = save only block outputs;
                                         # 'dots' = save matmul outputs
                                         # (less recompute, more HBM)

    # ---- derived ------------------------------------------------------
    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def n_layers(self) -> int:
        return sum(len(g.unit) * g.repeats for g in self.groups)

    @property
    def vocab_padded(self) -> int:
        return -(-self.vocab_size // 256) * 256  # multiple of 256 (16-way TP)

    def param_count(self) -> int:
        """Analytic parameter count (used for 6ND model FLOPs)."""
        from repro_torch.models.lm import init_params_shape_only
        from repro_torch.models.tree import leaves
        shapes = init_params_shape_only(self)
        return sum(int(np.prod(x.shape)) for x in leaves(shapes))

    def active_param_count(self) -> int:
        """Params touched per token (MoE: routed experts counted top_k/E)."""
        from repro_torch.models.lm import init_params_shape_only
        from repro_torch.models.tree import flatten_with_path
        shapes = init_params_shape_only(self)
        total = 0
        for path, leaf in flatten_with_path(shapes):
            n = int(np.prod(leaf.shape))
            # the reference's test, on the leaf's path: no leaf name holds
            # "experts" (the MoE leaves are ['moe']['w_gate'] and so on), so
            # this counts every routed expert, as the reference does
            if "experts" in path and self.n_experts:
                n = n * self.top_k // self.n_experts
            total += n
        return total


import numpy as np  # noqa: E402

_REGISTRY: dict[str, "ArchSpec"] = {}


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    config: ModelConfig
    reduced: ModelConfig                # smoke-test sized sibling
    skip_shapes: tuple[str, ...] = ()   # e.g. long_500k for quadratic attn
    skip_reason: str = ""


def register(arch_id: str, spec: ArchSpec) -> ArchSpec:
    _REGISTRY[arch_id] = spec
    return spec


def get_arch(arch_id: str) -> ArchSpec:
    if not _REGISTRY:
        _load_all()
    return _REGISTRY[arch_id]


def all_archs() -> dict[str, ArchSpec]:
    if not _REGISTRY:
        _load_all()
    return dict(_REGISTRY)


def _load_all() -> None:
    import importlib
    for mod in ("granite_34b", "command_r_35b", "llama3_405b", "gemma2_27b",
                "seamless_m4t_medium", "llava_next_34b", "rwkv6_1b6",
                "recurrentgemma_2b", "deepseek_v2_236b",
                "granite_moe_3b_a800m"):
        importlib.import_module(f"repro_torch.configs.{mod}")
