"""Config registry of the port: ``get_config("<arch-id>")`` for the archs
ported so far (twin of ``repro.configs``).  ``"<arch>-smoke"`` is the
reduced variant.  Every other arch id of the reference raises "not ported
yet"."""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.configs.base import (  # noqa: F401  (re-exported)
    ATTN, SSM, ArchConfig, SSMConfig, VOCAB_PAD, pad_vocab,
)

_MODULES = {
    "mamba2-780m": "repro_torch.configs.mamba2_780m",
    "smollm-360m": "repro_torch.configs.smollm_360m",
}
# archs of the reference whose families the port does not have yet
NOT_PORTED = ("internvl2-1b", "deepseek-v2-lite-16b", "dbrx-132b",
               "command-r-35b", "qwen3-14b", "musicgen-large", "gemma3-4b",
               "recurrentgemma-2b")

ARCH_IDS: List[str] = list(_MODULES)


def get_config(name: str) -> ArchConfig:
    if name.endswith("-smoke"):
        return get_config(name[: -len("-smoke")]).reduced()
    if name in NOT_PORTED:
        raise NotImplementedError(f"arch {name!r} is not ported yet; "
                                  f"ported: {ARCH_IDS}")
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_IDS}")
    return importlib.import_module(_MODULES[name]).CONFIG
