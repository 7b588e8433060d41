"""``repro_torch`` — the PyTorch / CUDA port of :mod:`repro` for NVIDIA H100.

The JAX package ``repro`` stays the reference; this package grows beside it
one slice at a time, with the same subpackage and module names so every
module has an obvious twin (``core/``, ``kernels/``, ``models/``, ``optim/``,
``data/``, ``api/``, ``configs/``, ``launch/``).  It imports ``torch`` and
numpy only — never ``jax`` and nothing of ``repro``.

The slices ported so far:

* the paper's ASFL case study on the single-RSU engine:
  ``repro_torch.api.run(ExperimentSpec())`` -> ``FederationSim`` ->
  ``CohortEngine.split_round``, with the cut-boundary codec (``int8`` and
  ``topk_int8`` wires) carried by four hand-written CUDA kernels
  (``kernels/csrc/codec.cu``);
* split-inference serving of the LM lane (paper §IV-C) for smollm-360m,
  mamba2-780m, gemma3-4b, recurrentgemma-2b, internvl2-1b and
  musicgen-large: ``python -m repro_torch.launch.serve`` ->
  ``core.distributed`` prefill / decode steps -> ``core.split`` ->
  ``models.transformer`` (attention, local attention, SSD, RG-LRU; text,
  vision and audio inputs), with rmsnorm, flash attention and the SSD
  chunk scan as hand-written CUDA kernels (``kernels/csrc/lm.cu``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a card they raise (:mod:`repro_torch.device`).
"""
