"""dbrx-132b — fine-grained MoE [hf:databricks/dbrx-base].

[moe] 40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352,
16 experts top-4.  Pure full attention -> long_500k skipped.
The memory-constrained adaptive cut strategy (core/adaptive.py) forces an
early cut here: one DBRX MoE layer is ~3.3B params, far beyond any
vehicle-side budget — exactly the paper's resource argument.

Its parameters are bfloat16 (``param_dtype``, 263 GB; the router
float32): one card serves only its ``-smoke`` and trains one full-width
layer.  It trains in bfloat16 with float32 moments, the MoE's aux
load-balance loss in the objective.
"""
from repro_torch.configs.base import ATTN_MOE, ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="dbrx-132b",
    family="moe",
    source="hf:databricks/dbrx-base",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab_size=100352,
    pattern=(ATTN_MOE,),
    moe=MoEConfig(n_experts=16, top_k=4, n_shared=0, d_ff_expert=10752,
                  capacity_factor=1.25),
    rope_theta=500_000.0,
    default_cut=1,
    param_dtype="bfloat16",
    subquadratic=False,
)
