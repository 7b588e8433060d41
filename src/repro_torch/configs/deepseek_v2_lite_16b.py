"""deepseek-v2-lite-16b — MLA + fine-grained MoE [arXiv:2405.04434].

[moe] 27L d_model=2048 16H (MLA kv_lora=512) vocab=102400,
MoE: 64 routed experts top-6 + 2 shared, expert d_ff=1408.
Layer 0 uses a dense FFN (d_ff=10944) per the model card; d_ff=1408 is the
*expert* hidden dim — both are kept.
Pure full attention (MLA) -> long_500k skipped.
"""
from repro_torch.configs.base import (MLA_DENSE, MLA_MOE, ArchConfig,
                                      MLAConfig, MoEConfig)

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    source="arXiv:2405.04434",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,       # MLA: cache is the 512-dim latent, not per-head KV
    head_dim=128,
    d_ff=10944,          # dense FFN hidden (layer 0)
    vocab_size=102400,
    pattern=(MLA_MOE,),
    tail=(MLA_DENSE,),   # note: model card puts the dense layer first; the
                         # stack here is period-tiled so the dense layer is
                         # placed as the tail — same cost, see DESIGN.md
    mla=MLAConfig(kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
                  v_head_dim=128),
    moe=MoEConfig(n_experts=64, top_k=6, n_shared=2, d_ff_expert=1408,
                  capacity_factor=1.25),
    default_cut=2,
    subquadratic=False,
)
