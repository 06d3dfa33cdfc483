"""The port stands alone: no file of ``agentlib_mpc_torch/`` and not
``chip_smoke.py`` imports JAX, the JAX package or ``bench.py``, and
importing them pulls none of those in. Entry points resolve their device
explicitly and never fall back to the CPU on their own."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

from agentlib_mpc_torch.utils.device import resolve_device

from _torch_threads import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "agentlib_mpc_tpu", "bench")


def _port_files():
    files = sorted((ROOT / "agentlib_mpc_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_the_port_loads_no_jax():
    modules = ["chip_smoke"] + sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(
            ".__init__")
        for p in (ROOT / "agentlib_mpc_torch").rglob("*.py"))
    code = ("import importlib, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r})\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_resolve_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cpu")).type == "cpu"


def test_entry_points_default_to_the_card(monkeypatch):
    """``device=None`` means CUDA at the entry points, so without a card
    they raise instead of quietly running on the CPU."""
    from agentlib_mpc_torch.parallel.admm_step import build_step, zone_ocp

    from agentlib_mpc_torch.parallel.config_bridge import FusedFleet
    from agentlib_mpc_torch.parallel.fused_admm import AgentGroup, FusedADMM

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_step(2)
    with pytest.raises(RuntimeError, match="CUDA"):
        zone_ocp().default_params()
    group = AgentGroup(name="zones", ocp=zone_ocp(), n_agents=2,
                       couplings={"c": "mDot"})
    with pytest.raises(RuntimeError, match="CUDA"):
        FusedADMM([group])
    with pytest.raises(RuntimeError, match="CUDA"):
        FusedFleet.from_configs([{"id": "Room_0", "modules": [
            {"type": "admm_local", "prediction_horizon": 3,
             "optimization_backend": {"model": {"class": "CooledRoom"}},
             "couplings": [{"name": "mDot"}]}]}])


def test_module_path_entry_points_default_to_the_card(monkeypatch):
    """LocalMAS, Agent and create_backend take the card unless given
    ``device="cpu"``; modules take their agent's device."""
    import agentlib_mpc_torch.modules  # noqa: F401 - registers types
    from agentlib_mpc_torch.backends.backend import create_backend
    from agentlib_mpc_torch.runtime.agent import Agent
    from agentlib_mpc_torch.runtime.environment import Environment
    from agentlib_mpc_torch.runtime.mas import LocalMAS

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda: LocalMAS([{"id": "a", "modules": []}]),
                  lambda: Agent({"id": "a", "modules": []}, Environment()),
                  lambda: create_backend({"type": "jax"})):
        with pytest.raises(RuntimeError, match="CUDA"):
            build()
    backend = create_backend({"type": "jax"}, device="cpu")
    assert backend.device == torch.device("cpu")
    assert backend.dtype == torch.float32
    mas = LocalMAS([{"id": "a", "modules": []}], device="cpu",
                   dtype=torch.float64)
    assert mas.agents["a"].device == torch.device("cpu")
    assert mas.agents["a"].dtype == torch.float64
