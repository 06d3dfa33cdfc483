"""The exchange example's loop on the module path, both packages, CPU, f64.

(h) ``examples/exchange_admm_4rooms.py`` cut to two rooms and the supplier
(``reference_configs.exchange_admm_4rooms_configs(rooms=(1, 2))``: two
``ExchangeRoom`` agents and the ``AirSupplier``, each an ``admm_local``
module on the one exchange alias ``air_balance``, and the two simulated
rooms), the closed loop to 300 s (one control step of 12 ADMM
iterations): per solve the same interior-point iterations, per ADMM
iteration the exchange trajectories within 1e-6, the plants and the
supplier's flow within 1e-6; each agent registered its peers. The
four-room width runs on the card (``chip_smoke.py``'s
``module_admm_exchange``); here it is cut to fit the test budget.

The plain LDLᵀ in both packages. The JAX side forces the routing its
sampled probe reaches (rooms "off", supplier "on"); the port routes on its
own certificates and must reach the same verdicts.
"""

import numpy as np
import pytest
import torch

import agentlib_mpc_tpu.modules  # noqa: F401 - registers module types
from agentlib_mpc_torch import reference_configs as rc
from agentlib_mpc_torch.runtime.mas import LocalMAS
from agentlib_mpc_tpu.runtime.mas import LocalMAS as JLocalMAS

from _torch_threads import one_torch_thread  # noqa: F401

F64 = torch.float64
SOLVER = {"kkt_method": "ldl"}
#: the exchange loop, per solve and per plant step, absolute (m³/s, K)
LOOP_TOL = 1e-6
#: the exchange loop's depth: one control step
EXCHANGE_UNTIL = 300.0


ROUTES = {"Room_1": "off", "Room_2": "off", "Supplier": "on"}


def exchange_configs(jax_side=False):
    cfgs = rc.exchange_admm_4rooms_configs(rooms=(1, 2), solver=SOLVER)
    if jax_side:
        for agent in cfgs:
            for module in agent["modules"]:
                if "optimization_backend" in module:
                    module["optimization_backend"]["solver"][
                        "qp_fast_path"] = ROUTES[agent["id"]]
    return cfgs


@pytest.fixture(scope="module")
def exchange_loops():
    port = LocalMAS(exchange_configs(), env={"rt": False}, device="cpu",
                    dtype=F64)
    port.run(until=EXCHANGE_UNTIL)
    ref = JLocalMAS(exchange_configs(jax_side=True), env={"rt": False})
    ref.run(until=EXCHANGE_UNTIL)
    return {"port": port, "jax": ref}


@pytest.mark.parametrize("agent", sorted(ROUTES))
def test_exchange_loop_matches_jax_per_solve(exchange_loops, agent):
    pm = exchange_loops["port"].agents[agent].get_module("admm")
    jm = exchange_loops["jax"].agents[agent].get_module("admm")
    assert pm.backend.uses_qp_fast_path == (ROUTES[agent] == "on")
    ps, js = pm.backend.stats_history, jm.backend.stats_history
    assert len(ps) == len(js) == 12
    for p, r in zip(ps, js):
        for key in ("iterations", "success", "kkt_path"):
            assert p[key] == r[key], (agent, key)
        assert p["success"]
    assert [r["iteration"] for r in pm._iter_rows] == list(range(12))
    for p, r in zip(pm._iter_rows, jm._iter_rows):
        for name, value in r["couplings"].items():
            np.testing.assert_allclose(p["couplings"][name], value, rtol=0,
                                       atol=LOOP_TOL, err_msg=name)
    wire = pm._wire_alias(pm.exchange[0])
    assert sorted(s.agent_id for s in pm._registered_participants[wire]) \
        == sorted(set(ROUTES) - {agent})


def test_exchange_loop_plants_match_jax(exchange_loops):
    for i in (1, 2):
        rows = [m.agents[f"Simulation_{i}"].get_module("simulator")._rows
                for m in (exchange_loops["port"], exchange_loops["jax"])]
        assert len(rows[0]) == len(rows[1]) == 5
        for key in ("T_out", "mDot"):
            np.testing.assert_allclose([r[key] for r in rows[0]],
                                       [float(r[key]) for r in rows[1]],
                                       rtol=0, atol=LOOP_TOL, err_msg=key)
    supply = [float(m.agents["Supplier"].get_module("admm")
                    .vars["mDot"].value)
              for m in (exchange_loops["port"], exchange_loops["jax"])]
    assert supply[0] == pytest.approx(supply[1], rel=0, abs=LOOP_TOL)
