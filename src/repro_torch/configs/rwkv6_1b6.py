"""rwkv6-1.6b [ssm] 24L d=2048 (attn-free) d_ff=7168 vocab=65536
— Finch: data-dependent decay [arXiv:2404.05892; unverified].

Sub-quadratic (O(1) state): runs the long_500k cell. The paper's MPC
technique level (distance/argmin protocols) does not interact with the
recurrence — runtime-level integration only (DESIGN.md §5 arch-applicability).
"""
from repro_torch.configs.base import ArchSpec, ModelConfig, ScanGroup, register

FULL = ModelConfig(
    name="rwkv6-1.6b", d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=7168, vocab_size=65536,
    groups=(ScanGroup(("rwkv",), 24),),
    rwkv_head_dim=64, act="relu_sq", sub_quadratic=True,
)

REDUCED = ModelConfig(
    name="rwkv6-1.6b-reduced", d_model=128, n_heads=2, n_kv_heads=2,
    d_ff=256, vocab_size=512,
    groups=(ScanGroup(("rwkv",), 2),),
    rwkv_head_dim=64, act="relu_sq", sub_quadratic=True,
)

register("rwkv6-1.6b", ArchSpec(config=FULL, reduced=REDUCED))
