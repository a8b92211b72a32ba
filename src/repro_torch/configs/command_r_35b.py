"""command-r-35b [dense] 40L d=8192 64H (GQA kv=8) d_ff=22528 vocab=256000
— GQA, no-bias [hf:CohereForAI/c4ai-command-r-v01; unverified]."""
from repro_torch.configs.base import ArchSpec, ModelConfig, ScanGroup, register

FULL = ModelConfig(
    name="command-r-35b", d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22528, vocab_size=256000,
    groups=(ScanGroup(("attn",), 40),),
    rope_theta=8000000.0, attn_bias=False, act="silu",
)

REDUCED = ModelConfig(
    name="command-r-35b-reduced", d_model=128, n_heads=8, n_kv_heads=2,
    d_ff=256, vocab_size=512,
    groups=(ScanGroup(("attn",), 2),),
)

register("command-r-35b", ArchSpec(
    config=FULL, reduced=REDUCED,
    skip_shapes=("long_500k",),
    skip_reason="pure full-attention arch (DESIGN.md §5)"))
