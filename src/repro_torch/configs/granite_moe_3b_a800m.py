"""granite-moe-3b-a800m [moe] 32L d=1536 24H (GQA kv=8) d_ff=512(expert)
vocab=49155, MoE 40e top-8 [hf:ibm-granite/granite-3.0-1b-a400m-base; hf].

(The assignment lists 'MoE 40e top-8' in the config field and '32 experts'
in the free text; we follow the config field: 40 experts, padded to 48 for
16-way expert parallelism — pad experts receive no tokens.)
"""
from repro_torch.configs.base import ArchSpec, ModelConfig, ScanGroup, register

FULL = ModelConfig(
    name="granite-moe-3b-a800m", d_model=1536, n_heads=24, n_kv_heads=8,
    d_ff=512, vocab_size=49155,
    groups=(ScanGroup(("moe_attn",), 32),),
    n_experts=40, top_k=8, d_ff_expert=512, capacity_factor=1.25,
    act="silu",
    # §Perf iter 3: per-example dispatch keeps the routing sort local to
    # each batch shard (a global sort over sharded tokens is a distributed
    # sort — it was this cell's bottleneck). 1.24x step on the pod.
    moe_dispatch="per_example",
)

REDUCED = ModelConfig(
    name="granite-moe-3b-a800m-reduced", d_model=128, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab_size=512,
    groups=(ScanGroup(("moe_attn",), 2),),
    n_experts=8, top_k=2, d_ff_expert=64,
)

register("granite-moe-3b-a800m", ArchSpec(
    config=FULL, reduced=REDUCED,
    skip_shapes=("long_500k",),
    skip_reason="pure full-attention arch (DESIGN.md §5)"))
