"""deepseek-v2-236b [moe] 60L d=5120 128H d_ff=1536(expert) vocab=102400,
MoE 160e top-6 — MLA kv_lora=512, 2 shared + 160 routed [arXiv:2405.04434;hf].

The strongest technique-level match for the paper (DESIGN.md §5): MoE
dispatch/combine are sparse one-hot x dense products — the same shape as
F_SCU's C^T X and Protocol 2 — implemented sort-based (nnz-proportional).
Decode uses the absorbed-matmul compressed-KV path (576 values/token).
First layer uses a dense MLP (d_ff 12288), per the released model.
"""
from repro_torch.configs.base import ArchSpec, ModelConfig, ScanGroup, register

FULL = ModelConfig(
    name="deepseek-v2-236b", d_model=5120, n_heads=128, n_kv_heads=128,
    d_ff=12288, vocab_size=102400,
    groups=(ScanGroup(("mla_dense",), 1), ScanGroup(("mla",), 59)),
    q_lora=1536, kv_lora=512, rope_head_dim=64, nope_head_dim=128,
    v_head_dim=128,
    n_experts=160, top_k=6, n_shared_experts=2, d_ff_expert=1536,
    d_ff_dense_first=12288, capacity_factor=1.25, act="silu",
    moe_dispatch="per_example",   # local routing sorts (see granite-moe)
)

REDUCED = ModelConfig(
    name="deepseek-v2-236b-reduced", d_model=128, n_heads=4, n_kv_heads=4,
    d_ff=256, vocab_size=512,
    groups=(ScanGroup(("mla_dense",), 1), ScanGroup(("mla",), 1)),
    q_lora=64, kv_lora=32, rope_head_dim=16, nope_head_dim=32, v_head_dim=32,
    n_experts=8, top_k=2, n_shared_experts=1, d_ff_expert=64,
    d_ff_dense_first=256,
)

register("deepseek-v2-236b", ArchSpec(
    config=FULL, reduced=REDUCED,
    skip_shapes=("long_500k",),
    skip_reason="full-attention (MLA is still quadratic-history) "
                "(DESIGN.md §5)"))
