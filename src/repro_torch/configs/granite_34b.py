"""granite-34b [dense] 88L d=6144 48H (GQA kv=1) d_ff=24576 vocab=49152
— llama-arch, code [arXiv:2405.04324; hf]."""
from repro_torch.configs.base import ArchSpec, ModelConfig, ScanGroup, register

FULL = ModelConfig(
    name="granite-34b", d_model=6144, n_heads=48, n_kv_heads=1,
    d_ff=24576, vocab_size=49152,
    groups=(ScanGroup(("attn",), 88),),
    rope_theta=10000.0, act="silu",
)

REDUCED = ModelConfig(
    name="granite-34b-reduced", d_model=128, n_heads=4, n_kv_heads=1,
    d_ff=256, vocab_size=512,
    groups=(ScanGroup(("attn",), 2),),
)

register("granite-34b", ArchSpec(
    config=FULL, reduced=REDUCED,
    skip_shapes=("long_500k",),
    skip_reason="pure full-attention arch: 500k dense decode is quadratic-"
                "history; skipped per assignment (DESIGN.md §5)"))
