"""Datacenter-scale SFL on one device (twin of ``repro.core.distributed``
without the mesh): the sync-SFL train step and the split-inference
prefill / decode steps (paper §IV-C).

Every step runs the vehicle-side periods, sends the smashed activations
across the cut, and runs the RSU-side periods and the head.  With
``compress_smashed`` the smashed tensor crosses as int8: the vehicle
quantizes and the RSU dequantizes with the codec kernels
(:func:`repro_torch.kernels.quant.fake_quant`, the reference's
``fake_quant``: its gradient passes straight through).

The train step is sync-SFL (aggregation every step, K = 1): client forward
-> smashed boundary -> server forward / backward -> client backward, one
|D_n|-weighted cross-entropy (:func:`weighted_ce`, the FedAvg objective of
paper Eq. 1 inside one step, read in float32) plus both sides' MoE aux
load-balance losses, global-norm clipping and the optimizer.  The prefill
and decode steps drop the aux loss, as the reference's do.  It trains
float32, bfloat16 or float16 parameters (``param_dtype``, as the
reference's: the forward and backward in the parameters' dtype, the
moments and the update in float32, the new parameter rounded back).
The step donates its state, as ``jax.jit(step, donate_argnums=0)``: the
optimizer runs leaf by leaf in place (``Optimizer.update_``), so the
caller's state is consumed and the state returned is the same storage (a
caller that needs the old state clones it).  ``donate=False`` is the
functional step, equal to it bit for bit, kept as the reference it is
held to.  The mesh placement of the smashed tensor (``smashed_sharding``) is
not ported yet; the prefill and decode steps serve the parameters in
whatever dtype they hold.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch import optim
from repro_torch.configs import TRAINED_DTYPES, check_trainable
from repro_torch.configs.base import ArchConfig
from repro_torch.core import split as SP
from repro_torch.kernels import quant
from repro_torch.models import transformer as T
from repro_torch.tree import tree_flatten


@dataclasses.dataclass
class DistOptions:
    cut: int = 2
    compress_smashed: bool = False
    remat: bool = True
    learning_rate: float = 3e-4
    optimizer: str = "adamw"
    grad_clip: float = 1.0
    smashed_sharding: Optional[Any] = None
    param_dtype: Any = None       # None -> cfg.param_dtype

    def __post_init__(self):
        if self.smashed_sharding is not None:
            raise NotImplementedError("smashed_sharding (the mesh placement "
                                      "of the smashed tensor) is not ported "
                                      "yet")
        if self.param_dtype not in _TRAINED_DTYPES:
            raise NotImplementedError(
                f"param_dtype={self.param_dtype!r}: training takes None, "
                f"float32, bfloat16 or float16 parameters; another dtype "
                f"is not ported yet")


# DistOptions.param_dtype values the train step takes (None: the config's)
_TRAINED_DTYPES = (None, *TRAINED_DTYPES,
                   *(getattr(torch, d) for d in TRAINED_DTYPES))


def _cross(smashed, opts: DistOptions):
    """The smashed tensor as the RSU receives it."""
    if not opts.compress_smashed:
        return smashed
    return quant.fake_quant(smashed)


def make_optimizer(opts: DistOptions) -> optim.Optimizer:
    if opts.optimizer == "adamw":
        return optim.adamw(opts.learning_rate, weight_decay=0.01)
    if opts.optimizer == "adam":
        return optim.adam(opts.learning_rate)
    return optim.sgd(opts.learning_rate)


def init_state(gen: torch.Generator, cfg: ArchConfig,
               opts: DistOptions) -> Dict[str, Any]:
    """Parameters drawn from ``gen`` (on its device) in
    ``opts.param_dtype`` (None: ``cfg.param_dtype``), the optimizer state
    and the step count."""
    params = T.init_params(gen, cfg, opts.param_dtype)
    return {"params": params, "opt": make_optimizer(opts).init(params),
            "step": torch.zeros((), dtype=torch.int32, device=gen.device)}


class _TokenCE(torch.autograd.Function):
    """Per position ``logsumexp(x) - x[label]`` of ``x = logits[:, start:,
    ..., :vocab]`` in float32: :func:`repro_torch.models.layers.
    per_token_ce`'s value, whose -1e9 mask on the padded vocab (as the
    reference's) leaves the padded tail out of the softmax, here left out
    of the sums.  One batch row at a time, so its float32 work is a row's;
    the backward writes ``(softmax - onehot) * g`` row by row into one
    gradient of the logits' shape and dtype (zero on the padded tail and
    the first ``start`` positions), where autograd of the plain ops held
    the float32 logits, their masked copy and ~3 more of that size."""

    @staticmethod
    def forward(ctx, logits, labels, vocab: int, start: int):
        per_tok, lse = [], []
        for x, y in zip(logits, labels):
            xs = x[start:, ..., :vocab].to(torch.float32)
            m = torch.logsumexp(xs, dim=-1)
            per_tok.append(m - torch.gather(xs, -1, y[..., None].long())[
                ..., 0])
            lse.append(m)
        ctx.save_for_backward(logits, labels, torch.stack(lse))
        ctx.vocab, ctx.start = vocab, start
        return torch.stack(per_tok)

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse = ctx.saved_tensors
        vocab, start = ctx.vocab, ctx.start
        grad = torch.empty(logits.shape, dtype=logits.dtype,
                           device=logits.device)
        grad[:, :start] = 0
        grad[..., vocab:] = 0
        for i in range(logits.shape[0]):
            p = logits[i, start:, ..., :vocab].to(torch.float32, copy=True)
            p.sub_(lse[i][..., None]).exp_()              # softmax
            idx = labels[i][..., None].long()
            p.scatter_(-1, idx, p.gather(-1, idx) - 1.0)   # - onehot
            p.mul_(g[i][..., None])
            grad[i, start:, ..., :vocab] = p
        return grad, None, None, None


def weighted_ce(logits, labels, weights, true_vocab: int,
                start: int = 0) -> torch.Tensor:
    """Per-sample-weighted token cross-entropy: the |D_n|-weighted FedAvg
    objective (paper Eq. 1) inside one step.  logits (b, s, vp) with labels
    (b, s - start), or audio's (b, s, K, vp) with (b, s, K): a sample's
    loss is the mean over its positions (and codebooks) from ``start``
    (vision's patch positions carry no label).  The logits are read in
    float32 (:class:`_TokenCE`)."""
    per_tok = _TokenCE.apply(logits, labels,
                             min(true_vocab, logits.shape[-1]), start)
    while per_tok.dim() > 1:
        per_tok = per_tok.mean(dim=-1)
    w = weights / torch.clamp(weights.sum(), min=1e-9)
    return torch.sum(per_tok * w)


def _labels_of(cfg: ArchConfig, batch) -> torch.Tensor:
    """The targets of a train batch: ``codes`` as (b, s, K) for audio (each
    frame predicts its own K codes, as the reference's), else
    ``labels``."""
    if cfg.frontend == "audio":
        return batch["codes"].transpose(1, 2)
    return batch["labels"]


def loss_and_grads(cfg: ArchConfig, opts: DistOptions, params, batch):
    """The train step's objective at ``params`` and its gradient in every
    leaf: client forward -> the smashed boundary -> server forward and
    head, ``ce`` the |D_n|-weighted cross-entropy (:func:`weighted_ce`),
    ``aux`` both sides' MoE load-balance losses, ``loss = ce + aux`` (the
    reference's ``ce + aux_c + aux_s``, in that order).  Returns (the
    gradients and the parameter leaves, both in ``tree_flatten`` order,
    the ``rebuild`` of that order, and {"loss", "ce", "aux"} as detached
    device scalars; ``aux`` is 0 without an MoE layer)."""
    cut = SP.clamp_cut(cfg, opts.cut)
    leaves, rebuild = tree_flatten(params)
    req = [t.detach().requires_grad_(True) for t in leaves]
    client, server = SP.split_params(rebuild(req), cfg, cut)
    smashed, positions, aux_c, _ = SP.client_forward(
        client, cfg, batch, cut, "train", remat=opts.remat)
    logits, aux_s, _ = SP.server_forward(
        server, cfg, _cross(smashed, opts), positions, cut, "train",
        remat=opts.remat)
    ce = weighted_ce(logits, _labels_of(cfg, batch), batch["weights"],
                     cfg.vocab_size,
                     cfg.n_patches if cfg.frontend == "vision" else 0)
    del logits
    loss = ce + aux_c + aux_s
    aux = aux_c + aux_s
    if not torch.is_tensor(aux):      # the float 0.0: no MoE layer
        aux = torch.zeros((), dtype=torch.float32, device=ce.device)
    grads = list(torch.autograd.grad(loss, req))
    return grads, leaves, rebuild, {"loss": loss.detach(),
                                    "ce": ce.detach(), "aux": aux.detach()}


def make_train_step(cfg: ArchConfig, opts: DistOptions,
                    donate: bool = True) -> Callable:
    """SFL round step: client fwd -> smashed boundary -> server fwd/bwd ->
    client bwd -> the |D_n|-weighted loss plus the MoE layers' aux
    load-balance loss (:func:`loss_and_grads`), clipping, the optimizer.
    The step donates ``state`` (the reference's ``donate_argnums``): the
    optimizer writes the parameters and moments in place, leaf by leaf, so
    the caller's state is consumed and the returned one holds the same
    tensors.  ``donate=False`` is the functional step (new parameter and
    moment trees, ``state`` left as it was), the same values bit for bit.
    ``step(state, batch)`` with ``weights`` (b,) and the frontend's inputs
    (:func:`repro_torch.launch.train.synth_batch`: ``tokens`` / ``labels``
    (b, s); for vision also ``patch_embeds``, whose positions are cut off
    the logits before the loss; for audio ``codes`` (b, K, s) alone)
    returns (new state, metrics: ``loss``, ``ce``, ``aux``, ``grad_norm``
    as device scalars)."""
    check_trainable(cfg)
    opt = make_optimizer(opts)

    def train_step(state, batch):
        grads, leaves, rebuild, metrics = loss_and_grads(
            cfg, opts, state["params"], batch)
        with torch.no_grad():
            if donate:
                scale, gnorm = (optim.clip_scale(grads, opts.grad_clip)
                                if opts.grad_clip > 0
                                else (None, optim.global_norm(grads)))
                opt_state = opt.update_(grads, state["opt"], leaves, scale)
                params = state["params"]
            else:
                grads = rebuild(grads)
                if opts.grad_clip > 0:
                    grads, gnorm = optim.clip_by_global_norm(grads,
                                                             opts.grad_clip)
                else:
                    gnorm = optim.global_norm(grads)
                updates, opt_state = opt.update(grads, state["opt"],
                                                state["params"])
                params = optim.apply_updates(state["params"], updates)
        metrics["grad_norm"] = gnorm
        return ({"params": params, "opt": opt_state,
                 "step": state["step"] + 1}, metrics)

    return train_step


def make_prefill_step(cfg: ArchConfig, opts: DistOptions,
                      capacity: int) -> Callable:
    """Prefill: vehicle-side periods over the prompt, one smashed upload,
    RSU-side periods fill their caches.  ``step(params, batch)`` (the
    batch of :func:`repro_torch.models.transformer.embed_inputs`) returns
    (last-position logits (b, 1, V), or (b, 1, K, V) for audio, and
    (client caches, server caches))."""
    cut = SP.clamp_cut(cfg, opts.cut)

    def prefill_step(params, batch):
        client, server = SP.split_params(params, cfg, cut)
        smashed, positions, _, c_caches = SP.client_forward(
            client, cfg, batch, cut, "prefill", capacity=capacity)
        logits, _, s_caches = SP.server_forward(
            server, cfg, _cross(smashed, opts), positions, cut, "prefill",
            capacity=capacity)
        return logits[:, -1:], (c_caches, s_caches)

    return prefill_step


def make_decode_step(cfg: ArchConfig, opts: DistOptions,
                     capacity: int) -> Callable:
    """Decode: ONE new token against the caches.  ``step(params, batch,
    caches, pos)`` with ``tokens`` (b, 1), or ``codes`` (b, K, 1) for
    audio, returns (logits (b, 1, V) or (b, 1, K, V), caches)."""
    cut = SP.clamp_cut(cfg, opts.cut)

    def decode_step(params, batch, caches, pos: int):
        client, server = SP.split_params(params, cfg, cut)
        c_caches, s_caches = caches
        smashed, positions, _, c_caches = SP.client_forward(
            client, cfg, batch, cut, "decode", caches=c_caches,
            capacity=capacity, pos_offset=pos)
        logits, _, s_caches = SP.server_forward(
            server, cfg, _cross(smashed, opts), positions, cut, "decode",
            caches=s_caches, capacity=capacity)
        return logits, (c_caches, s_caches)

    return decode_step
