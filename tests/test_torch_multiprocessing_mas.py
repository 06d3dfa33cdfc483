"""The port's process-per-agent MAS (``runtime/multiprocessing_mas.py``).

The reference's "multi-node" test is its multiprocessing ADMM example with
real spawned processes; here, as in ``tests/test_multiprocessing_mas.py``,
a data-source exciter and a simulator plant run in two processes started
by the ``spawn`` context and linked only through the TCP relay. Each
child builds its agent on the device and in the dtype the MAS was given
(here the CPU in float64); a probe module, registered by the
``bootstrap`` hook in each child, reports what the child's agent and
modules were built with. This file imports nothing of the JAX package, so
the spawned children (which import it to find the hook and the plant)
load no JAX.
"""

import numpy as np
import pytest
import torch

from agentlib_mpc_torch.models.model import Model, ModelEquations
from agentlib_mpc_torch.models.variables import (
    control_input,
    output,
    parameter,
    state,
)
from agentlib_mpc_torch.runtime.multiprocessing_mas import MultiProcessingMAS

from _torch_threads import one_torch_thread  # noqa: F401


class MPPlant(Model):
    inputs = [control_input("Q", 0.0, lb=0.0, ub=500.0)]
    states = [state("T", 295.15)]
    parameters = [parameter("C", 50000.0), parameter("load", 200.0)]
    outputs = [output("T_out")]

    def setup(self, v):
        eq = ModelEquations()
        eq.ode("T", (v.load - v.Q) / v.C)
        eq.alg("T_out", v.T)
        return eq


def register_probe():
    """Per-process bootstrap: one thread, and a ``device_probe`` module
    type whose results are what its agent was built with."""
    torch.set_num_threads(1)
    from agentlib_mpc_torch.runtime.module import BaseModule, register_module

    @register_module("device_probe")
    class DeviceProbe(BaseModule):
        def results(self):
            return {"agent_device": str(self.agent.device),
                    "agent_dtype": str(self.agent.dtype),
                    "modules": {mid: [str(m.device), str(m.dtype)]
                                for mid, m in self.agent.modules.items()},
                    "default_dtype": str(torch.get_default_dtype())}


SOURCE = {
    "id": "Source",
    "modules": [
        {"module_id": "com", "type": "multiprocessing_broadcast"},
        {"module_id": "excite", "type": "data_source", "t_sample": 10,
         "data": {"Q": {0.0: 100.0, 30.0: 400.0, 60.0: 250.0}},
         "interpolation_method": "previous"},
        {"module_id": "probe", "type": "device_probe"},
    ],
}
PLANT = {
    "id": "Plant",
    "modules": [
        {"module_id": "com", "type": "multiprocessing_broadcast"},
        {"module_id": "room", "type": "simulator",
         "model": {"class": MPPlant}, "t_sample": 10,
         "inputs": [{"name": "Q", "alias": "Q"}],
         "outputs": [{"name": "T_out", "alias": "T"}]},
        {"module_id": "probe", "type": "device_probe"},
    ],
}


def test_two_process_mas_on_the_device_and_dtype_it_was_given():
    mas = MultiProcessingMAS([SOURCE, PLANT],
                             env={"rt": True, "factor": 0.02},
                             bootstrap=register_probe, device="cpu",
                             dtype=torch.float64)
    mas.run(until=60, join_timeout=120.0)
    results = mas.get_results()
    assert set(results) == {"Source", "Plant"}
    for agent_id, modules in (("Source", ("excite", "probe")),
                              ("Plant", ("room", "probe"))):
        probe = results[agent_id]["probe"]
        assert probe["agent_device"] == "cpu"
        assert probe["agent_dtype"] == "torch.float64"
        assert probe["modules"] == {m: ["cpu", "torch.float64"]
                                    for m in modules}
    df = results["Plant"]["room"]
    # the plant integrated the excitation it received over TCP (one
    # sample of transport delay: inputs are read before the yield)
    assert df["Q"].max() == pytest.approx(400.0)
    assert df["Q"][df.index >= 20.0].min() == pytest.approx(100.0)
    assert df["T_out"].std() > 0.0
    assert np.isfinite(df["T_out"].to_numpy(dtype=float)).all()


def test_requires_rt():
    with pytest.raises(ValueError, match="real-time"):
        MultiProcessingMAS([], env={"rt": False}, device="cpu")


def test_no_card_raises_before_any_child_starts(monkeypatch):
    """``device=None`` means the card: without one the MAS raises in the
    parent instead of starting children on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MultiProcessingMAS([SOURCE, PLANT])
    mas = MultiProcessingMAS([SOURCE], device="cpu", dtype=torch.float32)
    try:
        assert mas.device == torch.device("cpu")
        assert mas.dtype == torch.float32
        assert mas.env_config == {"rt": True, "factor": 1.0}
    finally:
        mas.broker.close()
