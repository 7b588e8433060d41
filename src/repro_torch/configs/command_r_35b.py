"""command-r-35b — dense GQA, no-bias [hf:CohereForAI/c4ai-command-r-v01].

[dense] 40L d_model=8192 64H (GQA kv=8) d_ff=22528 vocab=256000.
Pure full attention -> long_500k skipped.  Its parameters are bfloat16
(``param_dtype``, 64.8 GB): served, and trained in bfloat16 (the
optimizer's moments in float32) at the depth one card holds.
"""
from repro_torch.configs.base import ATTN, ArchConfig

CONFIG = ArchConfig(
    name="command-r-35b",
    family="dense",
    source="hf:CohereForAI/c4ai-command-r-v01",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22528,
    vocab_size=256000,
    pattern=(ATTN,),
    mlp_variant="swiglu",
    rope_theta=8_000_000.0,
    default_cut=2,
    param_dtype="bfloat16",
    subquadratic=False,
)
