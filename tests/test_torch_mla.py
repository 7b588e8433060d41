"""Multi-head latent attention (deepseek-v2-lite-16b's mixer) against the
JAX package on the CPU, at the reduced MLA dims (kv_lora_rank 64, nope 32,
rope 16, v 32): ``mla_train``, ``mla_prefill`` (its output and its latent
cache) and ``mla_decode`` step by step up to and past the cache's last
slot, each within 1e-5 of the largest value; the rope on the head-less
``k_rope``; ``mla_flops``.  Parameters come from the reference's threefry
init (``kv_norm`` given a non-unit scale); inputs are numpy draws."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import cap_torch_threads, lm_configs
from repro.configs import get_config as jax_config
from repro.models import layers as JL
from repro.models import mla as JM
from repro_torch.configs import get_config
from repro_torch.models import layers as L
from repro_torch.models import mla as M

cap_torch_threads()

RTOL = 1e-5         # of the largest value: f32 sums in another order
ARCH = "deepseek-v2-lite-16b"


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= RTOL * scale, f"{what}: {err:g} of {scale:g}"


def _setup(seed=0):
    jcfg, tcfg = lm_configs(ARCH)
    p = jax.tree.map(np.asarray, JM.init_mla(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    r = jcfg.mla.kv_lora_rank
    p["kv_norm"]["scale"] = (1 + 0.2 * rng.normal(size=(r,))).astype(
        np.float32)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), p)
    return jcfg, tcfg, p, tp


def test_init_mla_has_the_reference_layout():
    jcfg, tcfg, p, _ = _setup()
    mine = M.init_mla(torch.Generator().manual_seed(0), tcfg)
    assert jax.tree.structure(jax.tree.map(lambda t: 0, mine)) == \
        jax.tree.structure(jax.tree.map(lambda a: 0, p))
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(p),
                            jax.tree.leaves(mine)):
        assert tuple(b.shape) == a.shape and b.dtype == torch.float32, path


@pytest.mark.parametrize("s", [1, 5, 37])
def test_rope_on_the_headless_k_rope_matches_reference(s):
    """(b, s, r) takes the broadcast branch (no head axis) on both
    sides; (b, s, h, r) the head branch."""
    rng = np.random.default_rng(s)
    pos = np.arange(s, dtype=np.int32) + 3
    for shape in ((2, s, 16), (2, s, 4, 16)):
        x = rng.normal(size=shape).astype(np.float32)
        got = L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4)
        want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4)
        _close(got.numpy(), want, f"rope {shape}")


@pytest.mark.parametrize("s", [1, 12, 37])
def test_mla_train_matches_reference(s):
    jcfg, tcfg, p, tp = _setup(1)
    x = np.random.default_rng(s).normal(size=(2, s, jcfg.d_model)).astype(
        np.float32)
    pos = np.arange(s, dtype=np.int32)
    want = jax.jit(JM.mla_train, static_argnums=1)(p, jcfg, jnp.asarray(x),
                                                   jnp.asarray(pos))
    got = M.mla_train(tp, tcfg, torch.from_numpy(x), torch.from_numpy(pos))
    _close(got.numpy(), want, "mla_train")


@pytest.mark.parametrize("s,cap", [(13, 16), (16, 16), (9, 24)])
def test_mla_prefill_and_decode_match_reference(s, cap):
    """Prefill's output and cache, then decode steps through slot
    ``cap - 1`` (pos = size - 1) and one past it (the last slot is
    written again, every key attends)."""
    jcfg, tcfg, p, tp = _setup(2)
    rng = np.random.default_rng(s + cap)
    x = rng.normal(size=(2, s, jcfg.d_model)).astype(np.float32)
    pos = np.arange(s, dtype=np.int32)
    jy, jc = jax.jit(JM.mla_prefill, static_argnums=(1, 4))(
        p, jcfg, jnp.asarray(x), jnp.asarray(pos), cap)
    ty, tc = M.mla_prefill(tp, tcfg, torch.from_numpy(x),
                           torch.from_numpy(pos), cap)
    _close(ty.numpy(), jy, "prefill y")
    decode = jax.jit(JM.mla_decode, static_argnums=1)
    n_steps = cap - s + 2       # positions s .. cap + 1
    for step in range(n_steps + 1):
        assert tc["pos"] == int(jc["pos"]) == s + step
        _close(tc["c_kv"].numpy(), jc["c_kv"], f"c_kv step {step}")
        _close(tc["k_rope"].numpy(), jc["k_rope"], f"k_rope step {step}")
        if step == n_steps:
            break
        xd = rng.normal(size=(2, 1, jcfg.d_model)).astype(np.float32)
        jy, jc = decode(p, jcfg, jnp.asarray(xd), jc)
        ty, tc = M.mla_decode(tp, tcfg, torch.from_numpy(xd), tc)
        _close(ty.numpy(), jy, f"decode y step {step}")
    assert tc["pos"] == cap + 2


def test_prefill_equals_train_and_decode_equals_prefill():
    """The port's prefill (latents computed once) returns mla_train's
    output bit for bit; prefill(s-1) + decode gives prefill(s)'s last
    row (the absorbed form against the materialised one)."""
    _, tcfg, _, tp = _setup(3)
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(2, 21, tcfg.d_model)).astype(np.float32))
    pos = torch.arange(21, dtype=torch.int32)
    y, _ = M.mla_prefill(tp, tcfg, x, pos, 24)
    assert torch.equal(y, M.mla_train(tp, tcfg, x, pos))
    _, cache = M.mla_prefill(tp, tcfg, x[:, :20], pos[:20], 24)
    dec, _ = M.mla_decode(tp, tcfg, x[:, 20:], cache)
    _close(dec[:, 0].numpy(), y[:, -1].numpy(), "absorbed decode")


@pytest.mark.parametrize("arch", [ARCH, ARCH + "-smoke"])
def test_mla_flops_match_reference(arch):
    for seq in (1, 1024, 37):
        assert M.mla_flops(get_config(arch), seq) == \
            JM.mla_flops(jax_config(arch), seq)
