"""mamba2-780m — SSD state-space duality [arXiv:2405.21060].

[ssm] 48L d_model=1536 (attention-free) vocab=50280, ssm_state=128.
d_inner = expand * d_model = 3072, n_heads = d_inner / head_dim = 48.
"""
from repro_torch.configs.base import SSM, ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-780m",
    family="ssm",
    source="arXiv:2405.21060",
    n_layers=48,
    d_model=1536,
    n_heads=48,          # d_inner / ssm.head_dim
    n_kv_heads=48,
    head_dim=64,
    d_ff=0,              # attention-free: no separate FFN
    vocab_size=50280,
    pattern=(SSM,),
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, d_conv=4, n_groups=1,
                  chunk=256),
    default_cut=8,
    subquadratic=True,
)
