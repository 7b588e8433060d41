"""recurrentgemma-2b — Griffin: RG-LRU + local attention, 1:2 [arXiv:2402.19427].

[hybrid] 26L d_model=2560 10H (MQA kv=1) d_ff=7680 vocab=256000.
Pattern: (recurrent, recurrent, local-attn) x 8 periods + (R, R) tail = 26.
Constant-size RG-LRU state + window-2048 local attention.
"""
from repro_torch.configs.base import ATTN_LOCAL, RGLRU, ArchConfig, RGLRUConfig

R = RGLRU
A = ATTN_LOCAL

CONFIG = ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    source="arXiv:2402.19427",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    pattern=(R, R, A),
    tail=(R, R),
    window=2048,
    mlp_variant="geglu",
    rglru=RGLRUConfig(d_rnn=2560, d_conv=4, c_exponent=8.0),
    default_cut=2,
    subquadratic=True,
)
