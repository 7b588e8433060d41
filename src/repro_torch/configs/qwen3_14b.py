"""qwen3-14b — dense GQA with qk_norm [hf:Qwen/Qwen3-8B family].

[dense] 40L d_model=5120 40H (GQA kv=8) d_ff=17408 vocab=151936.
Pure full attention -> long_500k skipped.  Its parameters are bfloat16
(``param_dtype``): ``init_params`` builds them so, and the port serves and
trains it in bfloat16 (the optimizer's moments in float32).
"""
from repro_torch.configs.base import ATTN, ArchConfig

CONFIG = ArchConfig(
    name="qwen3-14b",
    family="dense",
    source="hf:Qwen/Qwen3-8B",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=17408,
    vocab_size=151936,
    pattern=(ATTN,),
    qk_norm=True,
    mlp_variant="swiglu",
    rope_theta=1_000_000.0,
    default_cut=2,
    param_dtype="bfloat16",
    subquadratic=False,
)
