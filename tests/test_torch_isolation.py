"""The port stands alone: no module of src/repro_torch/, chip_smoke.py,
scripts/profile_port.py or the examples' ``*_torch.py`` twins imports jax,
jaxlib or the JAX package repro; and
its entry points default to cuda and raise without a card instead of
running on the CPU."""
import ast
import pathlib

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py", ROOT / "scripts" / "profile_port.py"] \
    + sorted((ROOT / "examples").glob("*_torch.py"))
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_files_exist():
    names = {p.name for p in PORT_FILES}
    assert {"chip_smoke.py", "fedsim.py", "quant.py", "wire.py",
            "compression.py", "runner.py", "lm_unit.py", "checkpoint.py",
            "train.py", "schedules.py", "superstep.py",
            "streaming.py"} <= names


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_repro_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for mod in _imported_modules(tree):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path}: imports {mod}"


def test_entry_points_raise_without_cuda(monkeypatch):
    from repro_torch import api
    from repro_torch.core import fedsim
    from repro_torch.models.mlp_unit import (MLPUnitModel,
                                             make_mlp_fleet_data)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = api.ExperimentSpec(model="mlp9")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.build_engine(spec)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.run(spec)
    clients, test = make_mlp_fleet_data(4, 16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fedsim.FederationSim(MLPUnitModel(), clients, test,
                             fedsim.SimConfig())
    # the explicit CPU request still works
    assert api.build_engine(spec, device="cpu").device.type == "cpu"
