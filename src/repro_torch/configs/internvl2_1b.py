"""internvl2-1b — InternViT + InternLM2 VLM backbone [arXiv:2404.16821].

[vlm] 24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655.
The vision encoder + projector is a stub frontend: a batch carries
precomputed patch embeddings (batch, n_patches, d_model), prepended to the
text embeddings.
"""
from repro_torch.configs.base import ATTN, ArchConfig

CONFIG = ArchConfig(
    name="internvl2-1b",
    family="vlm",
    source="arXiv:2404.16821",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151655,
    pattern=(ATTN,),
    mlp_variant="swiglu",
    rope_theta=1_000_000.0,
    frontend="vision",
    n_patches=256,
    default_cut=4,
    subquadratic=False,
)
