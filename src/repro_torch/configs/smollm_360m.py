"""smollm-360m — llama-arch small [hf:HuggingFaceTB/SmolLM-360M].

[dense] 32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152.
"""
from repro_torch.configs.base import ATTN, ArchConfig

CONFIG = ArchConfig(
    name="smollm-360m",
    family="dense",
    source="hf:HuggingFaceTB/SmolLM-135M",
    n_layers=32,
    d_model=960,
    n_heads=15,
    n_kv_heads=5,
    head_dim=64,
    d_ff=2560,
    vocab_size=49152,
    pattern=(ATTN,),
    mlp_variant="swiglu",
    default_cut=4,
    subquadratic=False,
)
