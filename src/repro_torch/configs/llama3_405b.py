"""llama3-405b [dense] 126L d=16384 128H (GQA kv=8) d_ff=53248 vocab=128256
— GQA 128k vocab [arXiv:2407.21783; unverified]."""
from repro_torch.configs.base import ArchSpec, ModelConfig, ScanGroup, register

FULL = ModelConfig(
    name="llama3-405b", d_model=16384, n_heads=128, n_kv_heads=8,
    d_ff=53248, vocab_size=128256,
    groups=(ScanGroup(("attn",), 126),),
    rope_theta=500000.0, act="silu",
)

REDUCED = ModelConfig(
    name="llama3-405b-reduced", d_model=128, n_heads=8, n_kv_heads=2,
    d_ff=384, vocab_size=512,
    groups=(ScanGroup(("attn",), 2),),
)

register("llama3-405b", ArchSpec(
    config=FULL, reduced=REDUCED,
    skip_shapes=("long_500k",),
    skip_reason="pure full-attention arch (DESIGN.md §5)"))
