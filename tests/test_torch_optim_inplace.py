"""The optimizers' in-place, leaf-by-leaf step (``Optimizer.update_``) and the
donated train step (``make_train_step``) against the functional forms
(``make_train_step(..., donate=False)``), bit for bit, on the CPU: sgd,
momentum (and Nesterov), adam and adamw, with and without global-norm
clipping, float32 and bfloat16 parameters (float32 moments), over three
steps, with the leaves walked in slices (``CHUNK`` made small) and whole (a
non-contiguous gradient); the gradients never written, and taken out of the
caller's list; ``global_norm`` by slices; the donated train step of a
bfloat16 and a float32 arch from the same state as the functional one,
returning the same storage; bfloat16 training through ``launch/train.py``
and its checkpoint bit for bit.  ``DistOptions.param_dtype`` takes None,
float32 and bfloat16, and refuses float16.  The train step's loss, row by
row with one logits-sized gradient, against autograd of the plain per-token
cross-entropy."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import optim
from repro_torch.ckpt import latest_step, restore_checkpoint
from repro_torch.configs import get_config
from repro_torch.core import distributed as D
from repro_torch.launch import train as TR
from repro_torch.optim import optimizers as O
from repro_torch.tree import tree_leaves, tree_map

OPTIMIZERS = {
    "sgd": lambda: optim.sgd(1e-2),
    "momentum": lambda: optim.momentum(1e-2),
    "nesterov": lambda: optim.momentum(1e-2, nesterov=True),
    "adam": lambda: optim.adam(3e-3),
    "adamw": lambda: optim.adamw(3e-3, weight_decay=0.01),
}
SHAPES = {"w": (7, 33), "b": (33,), "scale": (5,), "big": (3, 41, 17)}


@pytest.fixture
def one_thread():
    """One intra-op thread: a float reduction in a step's backward may then
    not change its order between two runs of the same step."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _tree(dtype, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy((scale * rng.normal(size=s)).astype(
        np.float32)).to(dtype) for k, s in SHAPES.items()}


def _clone(tree):
    return tree_map(lambda t: t.clone(), tree)


def _functional(opt, params, state, grads, clip):
    if clip:
        grads, norm = optim.clip_by_global_norm(grads, clip)
    else:
        norm = optim.global_norm(grads)
    updates, state = opt.update(grads, state, params)
    return optim.apply_updates(params, updates), state, norm


def _inplace(opt, params, state, grads, clip):
    leaves = tree_leaves(params)
    glist = tree_leaves(grads)
    scale, norm = (optim.clip_scale(glist, clip) if clip
                   else (None, optim.global_norm(glist)))
    state = opt.update_(glist, state, leaves, scale)
    assert glist == [None] * len(leaves)        # every gradient taken
    return params, state, norm


def _equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("clip", [0.0, 1.0])
@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_update_inplace_equals_functional_bit_for_bit(name, clip, dtype,
                                                      monkeypatch):
    """Three steps from the same parameters and gradients: the in-place
    step's parameters, moments, count and norm equal the functional
    step's bit for bit, in the same storage it was given; the leaves are
    walked in slices of 64 values (CHUNK made small, so slices end inside
    rows and a leaf's last slice is short)."""
    monkeypatch.setattr(O, "CHUNK", 64)
    opt = OPTIMIZERS[name]()
    params = _tree(dtype, 0)
    mine = _clone(params)
    state, my_state = opt.init(params), opt.init(mine)
    ptrs = [t.data_ptr() for t in tree_leaves([mine, my_state])]
    for step in range(3):
        grads = _tree(dtype, 10 + step, scale=0.5 + step)
        kept = _clone(grads)
        params, state, norm = _functional(opt, params, state, grads, clip)
        mine, my_state, my_norm = _inplace(opt, mine, my_state,
                                           _clone(grads), clip)
        assert _equal(grads, kept)
        assert torch.equal(norm, my_norm)
        assert _equal(params, mine) and _equal(state, my_state)
    assert [t.data_ptr() for t in tree_leaves([mine, my_state])
            if t.dim()] == [p for p, t in zip(
                ptrs, tree_leaves([mine, my_state])) if t.dim()]
    assert {t.dtype for t in tree_leaves(mine)} == {dtype}
    assert all(t.dtype in (torch.float32, torch.int32)
               for t in tree_leaves(my_state))


@pytest.mark.parametrize("name", ["sgd", "adamw"])
def test_update_inplace_reads_gradients_it_does_not_own(name):
    """Two leaves handed one gradient tensor, and a non-contiguous one
    (walked whole): each leaf gets the functional update, clipped once,
    and neither gradient is written."""
    opt = OPTIMIZERS[name]()
    params = _tree(torch.bfloat16, 1)
    mine = _clone(params)
    state, my_state = opt.init(params), opt.init(mine)
    shared = torch.from_numpy(np.random.default_rng(2).normal(
        size=SHAPES["b"]).astype(np.float32)).to(torch.bfloat16)
    grads = _tree(torch.bfloat16, 3)
    grads["b"] = shared
    grads["scale"] = shared[:5]
    grads["w"] = grads["w"].t().contiguous().t()
    assert not grads["w"].is_contiguous()
    kept = _clone(grads)
    params, state, _ = _functional(opt, params, state, _clone(grads), 1.0)
    mine, my_state, _ = _inplace(opt, mine, my_state, dict(grads), 1.0)
    assert _equal(grads, kept)
    assert _equal(params, mine) and _equal(state, my_state)


def test_global_norm_by_slices(monkeypatch):
    """A leaf of more than CHUNK values is summed by slices: within float32
    rounding of the whole-leaf sum; leaves up to CHUNK unchanged."""
    tree = _tree(torch.bfloat16, 4)
    whole = optim.global_norm(tree)
    monkeypatch.setattr(O, "CHUNK", 100)
    sliced = optim.global_norm(tree)
    assert float(abs(sliced - whole)) <= 1e-6 * float(whole)
    monkeypatch.setattr(O, "CHUNK", 10_000)
    assert torch.equal(optim.global_norm(tree), whole)
    scale, norm = optim.clip_scale(tree, 1.0)
    assert torch.equal(norm, whole)
    assert torch.equal(scale, torch.clamp(1.0 / (whole + 1e-9), max=1.0))


def _smoke(arch):
    cfg = get_config(arch).reduced()
    if len(cfg.pattern) == 1 and not cfg.tail:
        cfg = dataclasses.replace(cfg, n_layers=3)
    return cfg


@pytest.mark.parametrize("arch,optimizer,clip", [
    ("qwen3-14b", "adamw", 1.0), ("qwen3-14b", "sgd", 0.0),
    ("command-r-35b", "adam", 1.0), ("smollm-360m", "adamw", 1.0),
    ("mamba2-780m", "sgd", 1.0)])
def test_donated_train_step_equals_functional(arch, optimizer, clip,
                                              one_thread):
    """The donated step and the functional one from the same state over
    three steps: parameters, moments, counts and metrics bit for bit; the
    donated step returns the storage it was given (the parameters bfloat16
    where the config's are, the moments float32)."""
    cfg = _smoke(arch)
    opts = D.DistOptions(cut=1, optimizer=optimizer, grad_clip=clip,
                         learning_rate=1e-2)
    state = D.init_state(torch.Generator().manual_seed(0), cfg, opts)
    donated = _clone(state)
    ptrs = [t.data_ptr() for t in tree_leaves(donated["params"])]
    step = D.make_train_step(cfg, opts, donate=False)
    step_d = D.make_train_step(cfg, opts)
    for i in range(3):
        batch = TR.synth_batch(cfg, torch.Generator().manual_seed(i), 4, 32,
                               2)
        state, m = step(state, batch)
        donated, md = step_d(donated, batch)
        assert all(torch.equal(m[k], md[k]) for k in m)
    assert _equal(state, donated)
    assert [t.data_ptr() for t in tree_leaves(donated["params"])] == ptrs
    want = getattr(torch, cfg.param_dtype)
    assert {t.dtype for t in tree_leaves(donated["params"])} == {want}
    assert {t.dtype for t in tree_leaves(donated["opt"])} <= {
        torch.float32, torch.int32}
    assert int(donated["step"]) == 3


@pytest.mark.parametrize("param_dtype", [None, "float32", "bfloat16",
                                         torch.float32, torch.bfloat16])
def test_dist_options_take_the_trained_dtypes(param_dtype):
    opts = D.DistOptions(param_dtype=param_dtype)
    cfg = get_config("smollm-360m-smoke")
    state = D.init_state(torch.Generator().manual_seed(0), cfg, opts)
    want = (torch.float32 if param_dtype in (None, "float32", torch.float32)
            else torch.bfloat16)
    assert {t.dtype for t in tree_leaves(state["params"])} == {want}
    assert {t.dtype for t in tree_leaves([state["opt"]["m"],
                                          state["opt"]["v"]])} == \
        {torch.float32}


@pytest.mark.parametrize("param_dtype", ["int32", torch.int32,
                                         "float64"])
def test_dist_options_refuse_other_dtypes(param_dtype):
    with pytest.raises(NotImplementedError, match="not ported yet"):
        D.DistOptions(param_dtype=param_dtype)


@pytest.mark.parametrize("param_dtype", ["float16", torch.float16])
def test_dist_options_take_float16(param_dtype):
    assert D.DistOptions(param_dtype=param_dtype).param_dtype == param_dtype


@pytest.mark.parametrize("arch", ["qwen3-14b", "command-r-35b"])
def test_train_cli_trains_a_bf16_arch_and_checkpoints_it_exactly(
        arch, tmp_path, capsys, one_thread):
    """``launch/train.py --arch <bf16 arch> --smoke``: finite losses, and
    a checkpoint that restores the bfloat16 parameters bit for bit (the
    same run through ``train()`` gives them)."""
    assert TR.main(["--arch", arch, "--smoke", "--steps", "2", "--batch",
                    "4", "--seq", "16", "--device", "cpu", "--ckpt-dir",
                    str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "step    1 loss=" in out and "checkpoint ->" in out
    assert latest_step(str(tmp_path)) == 2
    cfg = get_config(arch).reduced()
    res = TR.train(cfg, steps=2, batch=4, seq=16, device="cpu")
    assert all(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
               for m in res["metrics"])
    params = res["state"]["params"]
    assert {t.dtype for t in tree_leaves(params)} == {torch.bfloat16}
    like = D.init_state(torch.Generator().manual_seed(7), cfg,
                        D.DistOptions())["params"]
    back = restore_checkpoint(str(tmp_path), 2, like)
    for a, b in zip(tree_leaves(back), tree_leaves(params)):
        assert a.dtype == b.dtype == torch.bfloat16
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))


@pytest.mark.parametrize("arch", ["smollm-360m", "gemma3-4b"])
def test_train_trains_any_arch_in_bf16_through_its_config(arch):
    """Any trained arch in bfloat16 through the config's own field
    (``dataclasses.replace(cfg, param_dtype="bfloat16")``): bfloat16
    parameters, float32 moments that moved, finite metrics."""
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              param_dtype="bfloat16")
    res = TR.train(cfg, steps=2, batch=4, seq=32, cut=1, device="cpu")
    assert all(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
               for m in res["metrics"])
    state = res["state"]
    assert {t.dtype for t in tree_leaves(state["params"])} == \
        {torch.bfloat16}
    moments = tree_leaves(state["opt"]["m"])
    assert {t.dtype for t in moments} == {torch.float32}
    assert all(float(t.abs().max()) > 0 for t in moments)


def _plain_weighted_ce(logits, labels, weights, vocab, start=0):
    """weighted_ce as autograd of the plain ops (the float32 mask of
    ``per_token_ce``), the patch positions sliced off."""
    from repro_torch.models import layers as L
    per_tok = L.per_token_ce(logits[:, start:], labels, vocab)
    while per_tok.dim() > 1:
        per_tok = per_tok.mean(dim=-1)
    return torch.sum(per_tok * weights / weights.sum())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,start,vocab", [
    ((3, 9, 64), 0, 50), ((3, 9, 64), 0, 64), ((2, 11, 48), 4, 40),
    ((2, 7, 4, 32), 0, 30)])
def test_weighted_ce_row_by_row_matches_plain_autograd(shape, start, vocab,
                                                       dtype):
    """The train step's loss (one batch row at a time, its backward one
    logits-sized gradient) against autograd of the plain per-token
    cross-entropy: text, a padded vocab, vision's patch positions
    (``start``) and audio's codebooks; the loss within float32 rounding,
    the gradient within it too (bfloat16 logits: within one ulp of
    bfloat16), zero on the padded tail and the patch positions."""
    rng = np.random.default_rng(len(shape) + start + vocab)
    logits = torch.from_numpy((3 * rng.normal(size=shape)).astype(
        np.float32)).to(dtype)
    labels = torch.from_numpy(rng.integers(
        0, vocab, size=(shape[0], shape[1] - start, *shape[2:-1])))
    weights = torch.from_numpy(rng.random(shape[0]).astype(np.float32))
    got_x = logits.clone().requires_grad_()
    got = D.weighted_ce(got_x, labels, weights, vocab, start)
    (got_g,) = torch.autograd.grad(got, got_x)
    want_x = logits.clone().requires_grad_()
    want = _plain_weighted_ce(want_x, labels, weights, vocab, start)
    (want_g,) = torch.autograd.grad(want, want_x)
    assert got.dtype == torch.float32 and got_g.dtype == dtype
    assert float(abs(got - want)) <= 1e-6 * float(abs(want))
    err = (got_g.float() - want_g.float()).abs()
    bound = 1e-6 * float(want_g.float().abs().max())
    if dtype == torch.bfloat16:
        bound = bound + want_g.float().abs() * 2.0 ** -7
    assert bool((err <= bound).all())
    assert not got_g[..., vocab:].any() and not got_g[:, :start].any()
