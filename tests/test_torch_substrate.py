"""The port's training substrate against the JAX package on the CPU: the
optimizers (adamw's decoupled weight decay, nesterov momentum, a
schedule as the learning rate), the schedules, ``global_norm`` /
``clip_by_global_norm`` (also under ``torch.func.vmap``, as
``CohortEngine`` steps stacked replicas), the LM fleet shards and stream
batches (exact), the bigram stream, and ``.npz`` checkpoints (round trip,
atomic write, ``latest_step``)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import cap_torch_threads
from repro import optim as JO
from repro.api import registry as JR
from repro.ckpt import checkpoint as JC
from repro.data import synthetic as JS
from repro_torch import optim as TO
from repro_torch.api import registry as TR
from repro_torch.ckpt import checkpoint as TC
from repro_torch.data import synthetic as TS

cap_torch_threads()

RTOL = 1e-6


def _tree(seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"a": (rng.normal(size=(4, 3)) * scale).astype(np.float32),
            "b": [(rng.normal(size=(5,)) * scale).astype(np.float32),
                  (rng.normal(size=(2, 2, 2)) * scale).astype(np.float32)]}


def _to_t(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _np(tree):
    return jax.tree.map(lambda t: t.numpy() if isinstance(t, torch.Tensor)
                        else np.asarray(t), tree,
                        is_leaf=lambda t: isinstance(t, torch.Tensor))


def _assert_trees_close(got, want, rtol=RTOL, atol=0.0):
    g, w = jax.tree.leaves(_np(got)), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=atol)


SCHEDULES = {
    "constant": lambda m: m.constant(0.1),
    "linear_warmup": lambda m: m.linear_warmup(0.1, 3),
    "cosine_decay": lambda m: m.cosine_decay(0.1, 5, alpha=0.1),
    "warmup_cosine": lambda m: m.warmup_cosine(0.1, 2, 6, alpha=0.05)}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedules_match_reference(name):
    j, t = SCHEDULES[name](JO), SCHEDULES[name](TO)
    counts = np.arange(0, 9, dtype=np.int32)
    want = np.array([float(j(jnp.asarray(c))) for c in counts])
    got = np.array([float(t(torch.tensor(int(c), dtype=torch.int32)))
                    for c in counts])
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-9)
    # tensor ops only: the schedule runs under vmap
    batched = torch.func.vmap(t)(torch.from_numpy(counts))
    np.testing.assert_allclose(batched.numpy(), got, rtol=0, atol=0)


OPTS = {
    "adamw": lambda m, lr: m.adamw(lr, weight_decay=0.01),
    "adam": lambda m, lr: m.adam(lr),
    "nesterov": lambda m, lr: m.momentum(lr, nesterov=True),
    "momentum": lambda m, lr: m.momentum(lr),
    "sgd": lambda m, lr: m.sgd(lr)}


@pytest.mark.parametrize("name", list(OPTS))
@pytest.mark.parametrize("sched", [None, "warmup_cosine"])
def test_optimizers_match_reference(name, sched):
    jlr = 0.05 if sched is None else SCHEDULES[sched](JO)
    tlr = 0.05 if sched is None else SCHEDULES[sched](TO)
    jopt, topt = OPTS[name](JO, jlr), OPTS[name](TO, tlr)
    jp, tp = _tree(0), _to_t(_tree(0))
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(4):
        g = _tree(10 + step)
        ju, js = jopt.update(g, js, jp)
        tu, ts = topt.update(_to_t(g), ts, tp)
        _assert_trees_close(tu, ju, atol=1e-8)
        jp = JO.apply_updates(jp, ju)
        tp = TO.apply_updates(tp, tu)
    _assert_trees_close(tp, jp)
    assert int(ts["count"]) == int(js["count"]) == 4


@pytest.mark.parametrize("name", ["adamw", "nesterov"])
def test_vmapped_update_equals_per_replica_updates(name):
    opt = OPTS[name](TO, SCHEDULES["linear_warmup"](TO))
    reps = [_to_t(_tree(i)) for i in range(3)]
    grads = [_to_t(_tree(20 + i)) for i in range(3)]
    stack = lambda ts: jax.tree.map(lambda *a: torch.stack(a), *ts,  # noqa
                                    is_leaf=lambda t: isinstance(
                                        t, torch.Tensor))
    sp, sg = stack(reps), stack(grads)
    so = torch.func.vmap(opt.init)(sp)
    upd, so2 = torch.func.vmap(opt.update)(sg, so, sp)
    for i in range(3):
        u, _ = opt.update(grads[i], opt.init(reps[i]), reps[i])
        _assert_trees_close(jax.tree.map(
            lambda a: a[i], upd, is_leaf=lambda t: isinstance(
                t, torch.Tensor)), _np(u), rtol=0)


def test_global_norm_and_clipping_match_reference():
    for scale, max_norm in ((1.0, 1.0), (0.01, 1.0), (3.0, 0.5)):
        g = _tree(3, scale)
        jn = float(JO.global_norm(g))
        tn = float(TO.global_norm(_to_t(g)))
        np.testing.assert_allclose(tn, jn, rtol=RTOL)
        jc, jnorm = JO.clip_by_global_norm(g, max_norm)
        tc, tnorm = TO.clip_by_global_norm(_to_t(g), max_norm)
        np.testing.assert_allclose(float(tnorm), float(jnorm), rtol=RTOL)
        _assert_trees_close(tc, jc)
    # under vmap: one norm per replica
    reps = [_tree(i, 2.0) for i in range(3)]
    stacked = jax.tree.map(lambda *a: torch.from_numpy(np.stack(a)), *reps)
    clipped, norms = torch.func.vmap(
        lambda t: TO.clip_by_global_norm(t, 1.0))(stacked)
    for i, r in enumerate(reps):
        c, n = JO.clip_by_global_norm(r, 1.0)
        np.testing.assert_allclose(float(norms[i]), float(n), rtol=RTOL)
        _assert_trees_close(jax.tree.map(
            lambda a: a[i], clipped, is_leaf=lambda t: isinstance(
                t, torch.Tensor)), c)


# ------------------------------------------------------------------- data
def test_lm_fleet_data_is_the_reference_draw():
    jc, jt = JR.make_lm_fleet_data(4, 6, 10, 3, 512, seq_len=9)
    tc, tt = TR.make_lm_fleet_data(4, 6, 10, 3, 512, seq_len=9)
    for a, b in zip(jc, tc):
        assert a.client_id == b.client_id
        assert a.images.dtype == b.images.dtype == np.int32
        assert np.array_equal(a.images, b.images)
        assert np.array_equal(a.labels, b.labels)
    assert np.array_equal(np.asarray(jt["images"]), tt["images"])
    assert np.array_equal(np.asarray(jt["labels"]), tt["labels"])


@pytest.mark.parametrize("batch,seq,step", [(4, 8, 0), (3, 16, 5),
                                            (8, 32, 2)])
def test_lm_batch_from_stream_is_exact(batch, seq, step):
    stream = np.random.default_rng(0).integers(0, 100, size=200).astype(
        np.int32)
    want = JS.lm_batch_from_stream(jnp.asarray(stream), batch, seq, step)
    got = TS.lm_batch_from_stream(torch.from_numpy(stream), batch, seq, step)
    for k in ("tokens", "labels"):
        assert np.array_equal(got[k].numpy(), np.asarray(want[k]))
    assert torch.equal(got["labels"][:, :-1], got["tokens"][:, 1:])


def test_bigram_stream_is_seeded_and_learnable():
    a = TS.make_bigram_lm(torch.Generator().manual_seed(0), 16, 4000)
    b = TS.make_bigram_lm(torch.Generator().manual_seed(0), 16, 4000)
    c = TS.make_bigram_lm(torch.Generator().manual_seed(1), 16, 4000)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.dtype == torch.int64 and 0 <= int(a.min()) <= int(a.max()) < 16
    # a bigram table: the next token given the previous is far from uniform
    counts = np.zeros((16, 16))
    np.add.at(counts, (a[:-1].numpy(), a[1:].numpy()), 1)
    p = counts / np.maximum(counts.sum(1, keepdims=True), 1)
    assert np.mean(p.max(1)) > 3 / 16


# ------------------------------------------------------------ checkpoints
def _state():
    g = torch.Generator().manual_seed(0)
    return {"params": {"w": torch.randn(3, 4, generator=g),
                       "segs": [(torch.randn(2, generator=g),
                                 {"s": torch.ones(5, dtype=torch.bfloat16)})]},
            "step": torch.tensor(7, dtype=torch.int32)}


def test_checkpoint_round_trip_and_latest_step(tmp_path):
    d = str(tmp_path / "ck")
    assert TC.latest_step(d) is None
    st = _state()
    path = TC.save_checkpoint(d, 12, st)
    TC.save_checkpoint(d, 3, st)
    assert os.path.basename(path) == "ckpt_00000012.npz"
    assert TC.latest_step(d) == JC.latest_step(d) == 12
    like = jax.tree.map(torch.zeros_like, st,
                        is_leaf=lambda t: isinstance(t, torch.Tensor))
    back = TC.restore_checkpoint(d, 12, like)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(st)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert isinstance(back["params"]["segs"][0], tuple)
    with np.load(path) as data:
        assert sorted(data) == ["params/segs/0/0", "params/segs/0/1/s",
                                "params/w", "step"]
    bad = {"params": {"w": torch.zeros(4, 3)}}
    with pytest.raises(ValueError, match="shape mismatch"):
        TC.restore_checkpoint(d, 12, bad)
    with pytest.raises(KeyError, match="missing leaf"):
        TC.restore_checkpoint(d, 12, {"nope": torch.zeros(1)})


def test_checkpoint_write_is_atomic(tmp_path, monkeypatch):
    d = str(tmp_path)
    TC.save_checkpoint(d, 1, _state())

    def boom(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(np, "savez", boom)
    with pytest.raises(OSError, match="disk full"):
        TC.save_checkpoint(d, 2, _state())
    # no torn file and no temporary left behind
    assert sorted(os.listdir(d)) == ["ckpt_00000001.npz"]
    assert TC.latest_step(d) == 1
