"""Config registry of the port: ``get_config("<arch-id>")`` for the archs
of the reference (twin of ``repro.configs``).  ``"<arch>-smoke"`` is the
reduced variant.

Every layer kind trains -- attention (global, local, GQA / MQA, qk-norm),
MLA, the MoE FFN (dense and grouped GShard dispatch, the aux load-balance
loss in the objective), SSM and RG-LRU -- with every frontend, rope and
sinusoidal positions and the SwiGLU, GeGLU and GeLU MLPs, in float32,
bfloat16 or float16 parameters: each backward is held to the reference's
``jax.grad``.  Any arch trains and serves in another of those dtypes
through ``dataclasses.replace(cfg, param_dtype="float16")`` (or
``"bfloat16"``).  A config whose parameters are in any other dtype
(float64, an integer type) is not trained: the train step,
``launch/train.py`` and ``TransformerUnitModel`` refuse it
(:func:`check_trainable`).  ``SERVE_ONLY`` lists the arch ids that are
served only: none (every registered arch is float32 or bfloat16).

``transformer.init_params`` builds an arch's parameters in its
``param_dtype`` (float32, or bfloat16 for qwen3-14b, command-r-35b and
dbrx-132b), as the reference does; training keeps the optimizer's
moments in float32 (:mod:`repro_torch.optim`)."""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.configs.base import (  # noqa: F401  (re-exported)
    ATTN, ATTN_LOCAL, ATTN_MOE, MLA_DENSE, MLA_MOE, RGLRU, SSM, ArchConfig,
    MLAConfig, MoEConfig, RGLRUConfig, SSMConfig, VOCAB_PAD, pad_vocab,
)

_MODULES = {
    "internvl2-1b": "repro_torch.configs.internvl2_1b",
    "mamba2-780m": "repro_torch.configs.mamba2_780m",
    "smollm-360m": "repro_torch.configs.smollm_360m",
    "musicgen-large": "repro_torch.configs.musicgen_large",
    "gemma3-4b": "repro_torch.configs.gemma3_4b",
    "recurrentgemma-2b": "repro_torch.configs.recurrentgemma_2b",
    "deepseek-v2-lite-16b": "repro_torch.configs.deepseek_v2_lite_16b",
    "dbrx-132b": "repro_torch.configs.dbrx_132b",
    "qwen3-14b": "repro_torch.configs.qwen3_14b",
    "command-r-35b": "repro_torch.configs.command_r_35b",
}
ARCH_IDS: List[str] = list(_MODULES)


def get_config(name: str) -> ArchConfig:
    if name.endswith("-smoke"):
        return get_config(name[: -len("-smoke")]).reduced()
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_IDS}")
    return importlib.import_module(_MODULES[name]).CONFIG


# the parameter dtypes the train step takes, each held against the
# reference's (whose DistOptions takes any dtype; the others are not)
TRAINED_DTYPES = ("float32", "bfloat16", "float16")


def untrained_features(cfg: ArchConfig) -> List[str]:
    """What ``cfg`` holds whose backward the port has not checked against
    the reference yet (empty: the config can be trained): parameters in a
    dtype outside ``TRAINED_DTYPES``."""
    if cfg.param_dtype not in TRAINED_DTYPES:
        return [f"{cfg.param_dtype} parameters"]
    return []


def check_trainable(cfg: ArchConfig) -> None:
    """Raise for a config the port does not train."""
    found = untrained_features(cfg)
    if found:
        raise NotImplementedError(
            f"training {cfg.name!r} is not ported yet ({', '.join(found)}); "
            f"it is served only")


# ported archs that are served but not trained yet
SERVE_ONLY = tuple(a for a in ARCH_IDS if untrained_features(get_config(a)))
