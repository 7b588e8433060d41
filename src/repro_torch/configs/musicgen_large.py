"""musicgen-large — decoder-only over EnCodec tokens [arXiv:2306.05284].

[audio] 48L d_model=2048 32H (kv=32, MHA) d_ff=8192 vocab=2048.
The EnCodec frontend is a stub: a batch carries per-codebook token ids
(batch, n_codebooks, seq); the model sums the 4 codebook embeddings of a
frame and predicts each codebook with its own head.  Plain (non-gated)
GeLU FFN and sinusoidal positions, as in the paper.
"""
from repro_torch.configs.base import ATTN, ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large",
    family="audio",
    source="arXiv:2306.05284",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    pattern=(ATTN,),
    mlp_variant="gelu",
    pos="sinusoidal",
    frontend="audio",
    n_codebooks=4,
    default_cut=4,
    subquadratic=False,
)
