"""recurrentgemma-2b [hybrid] 26L d=2560 10H (GQA kv=1) d_ff=7680
— RG-LRU + local attn, 1:2 [arXiv:2402.19427; hf].

Griffin pattern: (recurrent, recurrent, local-attention) x 8 + 2 trailing
recurrent blocks = 26 layers; local window 2048 => bounded state, runs the
long_500k cell.
"""
from repro_torch.configs.base import ArchSpec, ModelConfig, ScanGroup, register

FULL = ModelConfig(
    name="recurrentgemma-2b", d_model=2560, n_heads=10, n_kv_heads=1,
    d_head=256, d_ff=7680, vocab_size=256000,
    groups=(ScanGroup(("rglru", "rglru", "rglru_attn"), 8),
            ScanGroup(("rglru",), 2)),
    window=2048, lru_width=2560, conv_width=4, act="gelu",
    scale_embed=True, sub_quadratic=True,
)

REDUCED = ModelConfig(
    name="recurrentgemma-2b-reduced", d_model=128, n_heads=2, n_kv_heads=1,
    d_head=64, d_ff=256, vocab_size=512,
    groups=(ScanGroup(("rglru", "rglru", "rglru_attn"), 1),
            ScanGroup(("rglru",), 1)),
    window=32, lru_width=128, act="gelu", scale_embed=True,
    sub_quadratic=True,
)

register("recurrentgemma-2b", ArchSpec(config=FULL, reduced=REDUCED))
