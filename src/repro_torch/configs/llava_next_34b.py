"""llava-next-34b [vlm] 60L d=7168 56H (GQA kv=8) d_ff=20480 vocab=64000
— anyres tiling [hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified].

Backbone only (per assignment): the anyres vision tower is a STUB —
input_specs provides precomputed patch embeddings (B, n_patches, d_model)
which replace the sequence prefix.
"""
from repro_torch.configs.base import ArchSpec, ModelConfig, ScanGroup, register

FULL = ModelConfig(
    name="llava-next-34b", d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=20480, vocab_size=64000,
    groups=(ScanGroup(("attn",), 60),),
    rope_theta=5000000.0, frontend="vlm", n_patches=576, act="silu",
)

REDUCED = ModelConfig(
    name="llava-next-34b-reduced", d_model=128, n_heads=8, n_kv_heads=2,
    d_ff=256, vocab_size=512,
    groups=(ScanGroup(("attn",), 2),),
    frontend="vlm", n_patches=16,
)

register("llava-next-34b", ArchSpec(
    config=FULL, reduced=REDUCED,
    skip_shapes=("long_500k",),
    skip_reason="pure full-attention arch (DESIGN.md §5)"))
