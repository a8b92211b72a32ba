"""seamless-m4t-medium [audio] 12L d=1024 16H (GQA kv=16) d_ff=4096
vocab=256206 — enc-dec, multimodal [arXiv:2308.11596; hf].

Modality frontend is a STUB per the assignment: input_specs provides
precomputed speech-frame embeddings (B, S, d_model) feeding the encoder;
the decoder is a standard causal stack with cross-attention.
"""
from repro_torch.configs.base import ArchSpec, ModelConfig, ScanGroup, register

FULL = ModelConfig(
    name="seamless-m4t-medium", d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab_size=256206,
    groups=(ScanGroup(("xattn",), 12),),         # 12 decoder layers
    enc_dec=True, n_enc_layers=12, frontend="audio", act="gelu",
)

REDUCED = ModelConfig(
    name="seamless-m4t-medium-reduced", d_model=128, n_heads=4, n_kv_heads=4,
    d_ff=256, vocab_size=512,
    groups=(ScanGroup(("xattn",), 2),),
    enc_dec=True, n_enc_layers=2, frontend="audio", act="gelu",
)

register("seamless-m4t-medium", ArchSpec(
    config=FULL, reduced=REDUCED,
    skip_shapes=("long_500k",),
    skip_reason="full-attention enc-dec (DESIGN.md §5); decode shapes run "
                "(it has a decoder)"))
