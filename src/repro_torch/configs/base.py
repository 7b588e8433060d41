"""Architecture configuration of the LM lane (twin of ``repro.configs.base``).

The port keeps its own copy of what the ported families need: the layer ids
``ATTN``, ``ATTN_LOCAL``, ``ATTN_MOE``, ``MLA_DENSE``, ``MLA_MOE``, ``SSM``
and ``RGLRU``, :class:`MoEConfig`, :class:`MLAConfig`, :class:`SSMConfig`,
:class:`RGLRUConfig`, :class:`ArchConfig` with its derived properties and
:meth:`ArchConfig.reduced`, the vision / audio frontend fields, and the
Megatron-style vocabulary padding.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# Layer-type ids understood by models/transformer.py
ATTN = "attn"            # global attention + dense MLP
ATTN_LOCAL = "attn_local"  # sliding-window attention + dense MLP
ATTN_MOE = "attn_moe"    # global attention + MoE FFN
MLA_DENSE = "mla_dense"  # multi-head latent attention + dense MLP
MLA_MOE = "mla_moe"      # multi-head latent attention + MoE FFN
SSM = "ssm"              # Mamba2 SSD block (no separate FFN)
RGLRU = "rglru"          # RG-LRU recurrent block + dense MLP

VOCAB_PAD = 2048  # Megatron-style: pad embedding tables to a multiple of this


def pad_vocab(v: int) -> int:
    return ((v + VOCAB_PAD - 1) // VOCAB_PAD) * VOCAB_PAD


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int            # routed experts
    top_k: int
    n_shared: int = 0         # shared (always-on) experts
    d_ff_expert: int = 0      # expert hidden dim (0 -> use arch d_ff)
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    d_conv: int = 4
    n_groups: int = 1
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    d_rnn: int = 0          # 0 -> d_model
    d_conv: int = 4
    c_exponent: float = 8.0


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str               # dense | moe | ssm | hybrid | vlm | audio
    source: str               # citation (paper / model card)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0         # 0 -> d_model // n_heads
    # one repeating period of layer ids; the stack is pattern * n_periods
    # + tail, and n_layers == len(pattern) * n_periods + len(tail)
    pattern: Tuple[str, ...] = (ATTN,)
    tail: Tuple[str, ...] = ()
    qk_norm: bool = False
    window: int = 0
    rope_theta: float = 10000.0
    pos: str = "rope"
    mlp_variant: str = "swiglu"
    logit_softcap: float = 0.0
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    # modality frontend stub ("none" | "vision" | "audio")
    frontend: str = "none"
    n_patches: int = 256      # vision: patch embeddings prepended to text
    n_codebooks: int = 4      # audio: EnCodec codebooks summed at the input
    default_cut: int = 2      # default cut layer, in period units
    subquadratic: bool = False
    param_dtype: str = "float32"

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        return pad_vocab(self.vocab_size)

    @property
    def layer_types(self) -> Tuple[str, ...]:
        return tuple(self.pattern) * self.n_periods + tuple(self.tail)

    @property
    def n_periods(self) -> int:
        body = self.n_layers - len(self.tail)
        if body % len(self.pattern):
            raise ValueError(f"{self.name}: {self.n_layers} layers, pattern "
                             f"{self.pattern}, tail {self.tail} do not tile")
        return body // len(self.pattern)

    def param_count(self) -> int:
        """Analytic parameter count (for 6ND model-FLOPs in the roofline)."""
        from repro_torch.models.transformer import count_params  # lazy
        return count_params(self)

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: one period, d_model <= 256, <= 4 experts
        (the reference's rule, field for field)."""
        d = min(self.d_model, 256)
        n_heads = max(1, min(self.n_heads, 4))
        n_kv = max(1, min(self.n_kv_heads, n_heads))
        while n_heads % n_kv:
            n_kv -= 1
        moe = None
        if self.moe is not None:
            moe = dataclasses.replace(
                self.moe, n_experts=min(self.moe.n_experts, 4),
                top_k=min(self.moe.top_k, 2),
                n_shared=min(self.moe.n_shared, 1),
                d_ff_expert=min(self.moe.d_ff_expert or 128, 128))
        mla = None
        if self.mla is not None:
            mla = MLAConfig(kv_lora_rank=64, qk_nope_dim=32, qk_rope_dim=16,
                            v_head_dim=32)
        ssm = None
        if self.ssm is not None:
            ssm = dataclasses.replace(self.ssm, d_state=16, head_dim=16,
                                      chunk=32)
        rglru = None
        if self.rglru is not None:
            rglru = dataclasses.replace(self.rglru, d_rnn=0)
        return dataclasses.replace(
            self, name=self.name + "-smoke",
            n_layers=len(self.pattern) + len(self.tail),
            d_model=d, n_heads=n_heads, n_kv_heads=n_kv, head_dim=32,
            d_ff=min(self.d_ff, 512) or 0,
            vocab_size=min(self.vocab_size, 512),
            window=min(self.window, 16) if self.window else 0,
            moe=moe, mla=mla, ssm=ssm, rglru=rglru,
            n_patches=min(self.n_patches, 8),
            default_cut=1)
