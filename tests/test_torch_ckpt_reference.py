"""The port reads the JAX package's LM checkpoints
(``repro_torch.ckpt.restore_reference_checkpoint``).

The reference's ``save_checkpoint`` keys each leaf by its pytree path
(``"['segments']/[0]/[0]/['mixer']/['A_log']"``), each segment's periods
stacked along a leading axis, bfloat16 leaves widened to float32.  For six
archs' ``-smoke`` configs -- a dense one (smollm-360m), mamba2-780m,
qwen3-14b (bfloat16, qk-norm), deepseek-v2-lite-16b (MLA, MoE, a tail
segment), internvl2-1b (vision) and musicgen-large (audio: K embeddings and
heads) -- the reference writes a parameter tree and the port reads it into
its own init (another seed, so every value must come from the file): equal
bit for bit to ``bridge.lm_params_to_torch`` of the tree written, dtypes
included.  mamba2 and qwen3 write the reference's ``init_params`` itself;
the others write the port's init in the reference's layout
(``bridge.lm_params_to_numpy``), whose structure and dtypes are held equal
to the reference's ``init_params`` (``jax.eval_shape``), so the file's keys
are the ones the reference's init would give.  A leaf of the wrong shape
raises ``ValueError``, a missing one ``KeyError``."""
import jax
import numpy as np
import pytest
import torch

from _torch_parity import cap_torch_threads, jax_lm_params
from repro.ckpt.checkpoint import save_checkpoint as ref_save
from repro.configs import get_config as jax_config
from repro.models import transformer as JT
from repro_torch import bridge
from repro_torch.ckpt import restore_reference_checkpoint
from repro_torch.ckpt.checkpoint import _paths
from repro_torch.configs import get_config
from repro_torch.models import transformer as T

cap_torch_threads()

ARCHS = ("smollm-360m-smoke", "mamba2-780m-smoke", "qwen3-14b-smoke",
         "deepseek-v2-lite-16b-smoke", "internvl2-1b-smoke",
         "musicgen-large-smoke")
# archs whose file holds the reference's own init_params
REF_INIT = ("mamba2-780m-smoke", "qwen3-14b-smoke")


def _written(arch):
    """The reference-layout numpy tree ``arch``'s checkpoint holds."""
    jcfg, tcfg = jax_config(arch), get_config(arch)
    if arch in REF_INIT:
        return jax_lm_params(jcfg)
    tree = bridge.lm_params_to_numpy(
        T.init_params(torch.Generator().manual_seed(3), tcfg), tcfg)
    shapes = jax.eval_shape(lambda k: JT.init_params(k, jcfg),
                            jax.random.PRNGKey(0))
    assert jax.tree.structure(tree) == jax.tree.structure(shapes)
    assert [(a.shape, a.dtype) for a in jax.tree.leaves(tree)] == \
        [(s.shape, s.dtype) for s in jax.tree.leaves(shapes)]
    return tree


def _bits(t):
    return t.view(torch.int16) if t.element_size() == 2 else t


@pytest.mark.parametrize("arch", ARCHS)
def test_reads_the_reference_checkpoint_bit_for_bit(arch, tmp_path):
    tree = _written(arch)
    ref_save(str(tmp_path), 12, tree)
    cfg = get_config(arch)
    like = T.init_params(torch.Generator().manual_seed(7), cfg)
    got = dict(_paths(restore_reference_checkpoint(str(tmp_path), 12, like)))
    want = dict(_paths(bridge.lm_params_to_torch(tree, cfg)))
    assert list(got) == [p for p, _ in _paths(like)]
    assert set(got) == set(want)
    for key, t in got.items():
        assert t.dtype == want[key].dtype, key
        assert torch.equal(_bits(t), _bits(want[key])), key
    if cfg.param_dtype == "bfloat16":
        with np.load(tmp_path / "ckpt_00000012.npz") as data:
            assert {data[k].dtype.name for k in data} == {"float32"}


def test_a_wrong_shape_or_a_missing_leaf_raises(tmp_path):
    arch = "smollm-360m-smoke"
    tree = _written(arch)
    ref_save(str(tmp_path), 1, tree)
    cfg = get_config(arch)
    like = T.init_params(torch.Generator(), cfg)
    wider = dict(like, final_norm={"scale": torch.ones(cfg.d_model + 1)})
    with pytest.raises(ValueError, match="shape mismatch for "
                       r"\['final_norm'\]/\['scale'\]"):
        restore_reference_checkpoint(str(tmp_path), 1, wider)
    deeper = dict(like, segments=[list(like["segments"][0]) * 2])
    with pytest.raises(ValueError, match="shape mismatch"):
        restore_reference_checkpoint(str(tmp_path), 1, deeper)
    extra = dict(like, extra=torch.zeros(3))
    with pytest.raises(KeyError, match=r"\['extra'\]"):
        restore_reference_checkpoint(str(tmp_path), 1, extra)
    with pytest.raises(KeyError, match=r"missing leaf \['segments'\]/"
                       r"\[0\]/\[0\]/\['mixer'\]/\['w_nope'\]"):
        restore_reference_checkpoint(str(tmp_path), 1, {
            "segments": [[({"mixer": {"w_nope": torch.zeros(1)}},)]]})
