"""gemma3-4b — 5:1 local:global attention, 128k context [hf:google/gemma-3-1b-pt family].

[dense] 34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144.
Pattern: (5 sliding-window local + 1 global) x 5 periods + 4 local tail = 34.
The local layers (window 1024) keep ring-buffer KV caches of 1024 slots.
"""
from repro_torch.configs.base import ATTN, ATTN_LOCAL, ArchConfig

L = ATTN_LOCAL
G = ATTN

CONFIG = ArchConfig(
    name="gemma3-4b",
    family="dense",
    source="hf:google/gemma-3-1b-pt",
    n_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=10240,
    vocab_size=262144,
    pattern=(L, L, L, L, L, G),
    tail=(L, L, L, L),
    qk_norm=True,
    window=1024,
    mlp_variant="geglu",
    rope_theta=1_000_000.0,
    default_cut=1,
    subquadratic=True,
)
