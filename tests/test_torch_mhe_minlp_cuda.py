"""The MHE and MINLP examples' agents on the card (marker ``cuda``; they
skip without one). This file imports no JAX, so it runs on a machine that
has only the port.

* ``examples/mhe_one_room.py``'s agents for 600 s in float64: the MHE QP
  at (1, 142) and the MPC at (1, 92) on the float64 kernels, one factor
  per inner iteration, every solve successful;
* ``examples/minlp_switched_room.py``'s ``jax_cia`` agent for 900 s in
  float64: the relaxed program's (1, 34) and the fixed program's (1, 26),
  one factor per inner iteration, every solve successful.
"""

import pytest
import torch

from agentlib_mpc_torch import reference_configs as rc
from agentlib_mpc_torch.ops import kkt
from agentlib_mpc_torch.runtime.mas import LocalMAS

from _torch_threads import one_torch_thread  # noqa: F401

F64 = torch.float64


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")


@pytest.mark.cuda
def test_mhe_example_on_the_card(card):
    mas = LocalMAS(rc.mhe_one_room_configs(), env={"rt": False}, dtype=F64)
    kkt.reset_launch_counts()
    mas.run(until=600.0)
    ctrl = mas.agents["Controller"]
    iterations = 0
    for name in ("mhe", "mpc"):
        stats = ctrl.get_module(name).backend.stats_history
        assert all(r["success"] and r["kkt_path"] == "ldl" for r in stats)
        iterations += sum(r["iterations"] for r in stats)
    assert kkt.ldl_factor.launches == iterations
    assert kkt.ldl_factor.shapes_f64 == {(1, 142), (1, 92)}
    assert not kkt.ldl_factor.shapes


@pytest.mark.cuda
def test_cia_agent_on_the_card(card):
    mas = LocalMAS(rc.minlp_switched_room_configs(), env={"rt": False},
                   dtype=F64)
    module = mas.agents["Controller"].get_module("mpc")
    kkt.reset_launch_counts()
    mas.run(until=900.0)
    stats = module.backend.stats_history
    assert all(r["success"] and r["relaxed_success"] for r in stats)
    assert kkt.ldl_factor.launches == sum(r["iterations"] for r in stats)
    assert kkt.ldl_factor.shapes_f64 == {(1, 34), (1, 26)}
    assert not kkt.ldl_factor.shapes
