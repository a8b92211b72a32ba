"""gemma2-27b [dense] 46L d=4608 32H (GQA kv=16) d_ff=36864 vocab=256000
— local+global alternating, logit softcap [arXiv:2408.00118; hf]."""
from repro_torch.configs.base import ArchSpec, ModelConfig, ScanGroup, register

FULL = ModelConfig(
    name="gemma2-27b", d_model=4608, n_heads=32, n_kv_heads=16,
    d_head=128, d_ff=36864, vocab_size=256000,
    groups=(ScanGroup(("attn_local", "attn"), 23),),  # 46 layers
    window=4096, attn_softcap=50.0, final_softcap=30.0,
    post_norms=True, act="gelu", scale_embed=True,
)

REDUCED = ModelConfig(
    name="gemma2-27b-reduced", d_model=128, n_heads=4, n_kv_heads=2,
    d_head=32, d_ff=256, vocab_size=512,
    groups=(ScanGroup(("attn_local", "attn"), 1),),
    window=32, attn_softcap=50.0, final_softcap=30.0,
    post_norms=True, act="gelu", scale_embed=True,
)

register("gemma2-27b", ArchSpec(
    config=FULL, reduced=REDUCED,
    skip_shapes=("long_500k",),
    skip_reason="alternating local/global: the GLOBAL layers are still "
                "quadratic-history at 500k, so not purely sub-quadratic; "
                "skipped and noted (DESIGN.md §5)"))
