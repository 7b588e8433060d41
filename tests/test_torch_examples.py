"""The port's example twins run on the CPU at their smallest arguments:
``examples/split_inference_torch.py`` (split serving of the reduced
smollm-360m with a float and an int8 uplink; its greedy ids, logits drift
and uplink bytes) and ``examples/vehicular_sim_torch.py`` (the strategy
trace on the port's channel / adaptive / cost modules, printed line for
line as the JAX example prints it, and ``--train`` rounds through
``repro_torch.api.run`` under the memory strategy)."""
import importlib.util
import math
from pathlib import Path

import pytest

from _torch_parity import cap_torch_threads
from repro_torch.configs import get_config

cap_torch_threads()

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _example(name):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES /
                                                  f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("args", [[], ["--dtype", "float16",
                                       "--arch", "mamba2-780m"]])
def test_split_inference_example_runs_on_cpu(args, capsys):
    out = _example("split_inference_torch").main(
        ["--device", "cpu", "--batch", "2", "--prompt-len", "8",
         "--steps", "2", *args])
    text = capsys.readouterr().out
    assert "uplink per decode step" in text and "int8 uplink" in text
    assert len(out["ids"]) == len(out["ids_int8"]) == 2
    assert math.isfinite(out["drift"]) and out["drift"] < out["max_logit"]
    # a decode step's (2, 1, d) smashed tensor: 4 / 2 B a value in float32
    # / float16, or int8 with one float32 scale per group of 128
    d = get_config(("mamba2-780m" if args else "smollm-360m")
                   + "-smoke").d_model
    assert out["uplink_bytes"] == 2 * d * (2 if args else 4)
    assert out["uplink_bytes_int8"] == 2 * d + 4 * 2 * math.ceil(d / 128)


def test_vehicular_sim_example_matches_the_jax_example(capsys):
    """The strategy trace prints what the JAX example prints (its one
    non-ASCII dash aside), and ``--train`` runs one ASFL round of mlp9
    through ``api.run`` on the CPU with memory-clamped cuts."""
    ref = _example("vehicular_sim")
    ref.strategy_trace(4)
    want = capsys.readouterr().out.replace("—", "--")
    port = _example("vehicular_sim_torch")
    out = port.main(["--vehicles", "4", "--train", "--rounds", "1",
                     "--model", "mlp9", "--device", "cpu"])
    got = capsys.readouterr().out
    assert got.startswith(want)
    assert "round 0: loss=" in got and "on cpu" in got
    (m,) = out["result"].history
    assert math.isfinite(m.loss) and len(m.cuts) == 4
