"""The reference's agent configs for the module path, as plain dicts.

- :func:`one_room_configs`: the two-agent MAS of
  ``tests/test_mas_one_room.py`` (the reference's ``simple_mpc.py``): an
  MPC agent controlling the ``OneRoom`` zoo model (degree-2 Legendre
  collocation, N=15 by default, a step every 300 s) and a simulated room
  that takes its plant step every 10 s;
- :func:`linear_qp_config`: the agent of ``examples/linear_qp_mpc.py``:
  MPC and plant of a ``LinearRCZone`` in one agent (N=8, a step every
  300 s), which the certified-LQ routing sends to the QP fast path.

Each takes a ``solver`` dict merged over its solver options (for example
``{"kkt_method": "ldl"}``). Run them with
``LocalMAS(configs, env={"rt": False}, device="cpu", dtype=torch.float64)``
(``agentlib_mpc_torch.runtime.mas``), or on the card with the default
``device``.
"""

from __future__ import annotations

#: the one-room MAS: horizon, plant step (s), comfort bound and supply
#: temperature (K)
ONE_ROOM_N, ONE_ROOM_PLANT_DT = 15, 10.0
ONE_ROOM_UB, ONE_ROOM_T_IN = 295.15, 290.15
#: the linear-QP agent: comfort bound and start temperature (K)
LINEAR_QP_UPPER, LINEAR_QP_START = 295.15, 299.15


def one_room_configs(horizon: int = ONE_ROOM_N, solver: dict | None = None):
    """tests/test_mas_one_room.py's two-agent MAS with the model named by
    its zoo name: the MPC agent and the simulated room."""
    mpc = {
        "id": "myMPCAgent",
        "modules": [
            {"module_id": "Ag1Com", "type": "local_broadcast"},
            {
                "module_id": "myMPC",
                "type": "mpc",
                "optimization_backend": {
                    "type": "jax",
                    "model": {"class": "OneRoom"},
                    "discretization_options": {
                        "collocation_order": 2,
                        "collocation_method": "legendre",
                    },
                    "solver": {"max_iter": 60, **(solver or {})},
                },
                "time_step": 300,
                "prediction_horizon": horizon,
                "parameters": [
                    {"name": "s_T", "value": 0.001},
                    {"name": "r_mDot", "value": 0.01},
                ],
                "inputs": [
                    {"name": "T_in", "value": ONE_ROOM_T_IN},
                    {"name": "load", "value": 150},
                    {"name": "T_upper", "value": ONE_ROOM_UB},
                ],
                "controls": [{"name": "mDot", "value": 0.02, "ub": 0.05,
                              "lb": 0}],
                "outputs": [{"name": "T_out"}],
                "states": [
                    {"name": "T", "value": 298.16, "ub": 303.15,
                     "lb": 288.15, "alias": "T", "source": "SimAgent"},
                ],
            },
        ],
    }
    sim = {
        "id": "SimAgent",
        "modules": [
            {"module_id": "Ag1Com", "type": "local_broadcast"},
            {
                "module_id": "room",
                "type": "simulator",
                "model": {"class": "OneRoom",
                          "states": [{"name": "T", "value": 298.16}]},
                "t_sample": ONE_ROOM_PLANT_DT,
                "outputs": [{"name": "T_out", "value": 298, "alias": "T"}],
                "inputs": [{"name": "mDot", "value": 0.02, "alias": "mDot"}],
            },
        ],
    }
    return [mpc, sim]


def linear_qp_config(solver: dict | None = None) -> dict:
    """examples/linear_qp_mpc.py's agent config (MPC and plant in one
    agent)."""
    t_upper, start = LINEAR_QP_UPPER, LINEAR_QP_START
    return {
        "id": "LinearZone",
        "modules": [
            {"module_id": "com", "type": "local_broadcast"},
            {
                "module_id": "mpc",
                "type": "mpc",
                "optimization_backend": {
                    "type": "jax",
                    "model": {"class": "LinearRCZone"},
                    "discretization_options": {"collocation_order": 2},
                    "solver": {"max_iter": 60, "tol": 1e-4,
                               **(solver or {})},
                },
                "time_step": 300.0,
                "prediction_horizon": 8,
                "inputs": [
                    {"name": "load", "value": 150.0},
                    {"name": "T_amb", "value": 303.15},
                    {"name": "T_upper", "value": t_upper},
                ],
                "states": [
                    {"name": "T", "value": start, "ub": 310.15,
                     "lb": 288.15},
                    {"name": "T_slack", "value": 0.0},
                ],
                "controls": [
                    {"name": "Q", "value": 0.0, "ub": 500.0, "lb": 0.0},
                ],
                "parameters": [
                    {"name": "C", "value": 100000.0},
                    {"name": "R", "value": 0.05},
                    {"name": "s_T", "value": 1.0},
                    {"name": "r_Q", "value": 1e-3},
                ],
            },
            {
                "module_id": "sim",
                "type": "simulator",
                "model": {"class": "LinearRCZone",
                          "states": [{"name": "T", "value": start}]},
                "t_sample": 300.0,
                "outputs": [{"name": "T_out", "value": start,
                             "alias": "T"}],
                "inputs": [{"name": "Q", "value": 0.0, "alias": "Q"}],
            },
        ],
    }
