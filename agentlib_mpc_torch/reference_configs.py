"""The reference's agent configs for the module path, as plain dicts.

- :func:`one_room_configs`: the two-agent MAS of
  ``tests/test_mas_one_room.py`` (the reference's ``simple_mpc.py``): an
  MPC agent controlling the ``OneRoom`` zoo model (degree-2 Legendre
  collocation, N=15 by default, a step every 300 s) and a simulated room
  that takes its plant step every 10 s;
- :func:`linear_qp_config`: the agent of ``examples/linear_qp_mpc.py``:
  MPC and plant of a ``LinearRCZone`` in one agent (N=8, a step every
  300 s), which the certified-LQ routing sends to the QP fast path;
- :func:`mhe_one_room_configs`: the two agents of
  ``examples/mhe_one_room.py``: a controller running an ``mhe`` module
  (``jax_mhe``, horizon 10, a step every 120 s, degree-2 collocation)
  beside an ``mpc`` that consumes its live load estimate, and a plant
  with the true load, all on :class:`RoomLoadParam` (the example's model);
- :func:`mhe_estimator_configs`: the estimator and plant of
  ``tests/test_mhe.py`` on :class:`RoomWithLoadParam` (horizon 8, 60 s);
- :func:`minlp_switched_room_configs`: the two agents of
  ``examples/minlp_switched_room.py``: a ``minlp_mpc`` over ``jax_cia``
  (``max_switches`` 6) or ``jax_minlp_bb`` (``max_nodes`` 48,
  ``batch_pairs`` 4) on the ``SwitchedRoom`` zoo model (multiple
  shooting, N=8, a step every 300 s) and its plant;
- :func:`switched_room_backend_config`: the backend configs of
  ``tests/test_minlp.py``;
- :func:`admm_cooled_room_configs`: the three agents of
  ``examples/admm_cooled_room.py``: a room (``CooledRoom``) and a cooler
  (``Cooler``), each an ``admm_local`` module over ``jax_admm`` (degree-2
  Legendre collocation, N=8, a step every 300 s, 6 ADMM iterations, rho
  10, budget 40) coupled on the air flow (the room's input ``mDot``, the
  cooler's output ``mDot_out``, wire alias ``mDotCoolAir``), and the
  simulated room (a plant step every 60 s);
- :func:`admm_realtime_pair_configs`: the wall-clock pair of
  ``tests/test_admm_realtime.py``: the same two models as ``admm``
  modules (N=4, a step every 8 s, 3 ADMM iterations, a 0.3 s
  registration window, budget 25, precompiled), wire alias ``air``;
- :func:`coordinator_pair_configs`: ``tests/test_coordinator.py``'s
  coordinator (``admm_coordinator``: 12 ADMM iterations at most, rho 10,
  abs_tol 1e-4, rel_tol 1e-3, penalty change threshold 10), the room and
  the cooler as ``admm_coordinated`` participants (budget 40) coupled on
  ``mDotCoolAir``, and the simulated room;
- :func:`admm_4rooms_coordinator_configs`: the ten agents of
  ``examples/admm_4rooms_coordinator.py``: the coordinator (15 ADMM
  iterations at most, rho 10, the tolerances and penalty change above),
  four ``CooledRoom`` participants with heat loads 80, 110, 140 and 170 W,
  each coupled on its own air flow ``mDotCoolAir_i``, the
  ``AirHandlingUnit`` participant (four controls under the shared capacity
  0.075 m³/s, four output couplings), budget 60, and the four simulated
  rooms;
- :func:`exchange_admm_4rooms_configs`: the nine agents of
  ``examples/exchange_admm_4rooms.py``: four ``ExchangeRoom`` agents and the
  ``AirSupplier``, each an ``admm_local`` module (12 ADMM iterations, rho
  50, budget 60) on the one exchange alias ``air_balance``, and the four
  simulated rooms (``rooms`` picks a subset of the rooms);
- the data-driven examples: :class:`SurrogateRoom` with
  :func:`ml_room_training_data`, :func:`train_room_surrogate`,
  :func:`ml_room_plant_step` and :func:`ml_mpc_backend_config`
  (``examples/ml_mpc_one_room.py``: an ANN NARX surrogate of a
  first-order room, hidden (16, 16), 300 epochs, lr 3e-3, controlled by
  ``jax_ml`` at N=10 and a step every 300 s), and :class:`ZoneSurrogate`,
  :class:`ThreePortAHU`, :func:`train_zone_surrogate` and
  :func:`three_zone_datadriven_configs`
  (``examples/three_zone_datadriven_admm.py``: three ``jax_admm_ml``
  zones and the physical AHU as ``admm_local`` modules, HORIZON 8, 10 ADMM
  iterations, rho 20, and three simulated ``CooledRoom`` plants);
- :func:`tracker_ocp`: the JAX package's gate workload, a one-control
  tracker (N=4 multiple shooting), the scenario fleet's test problem.

The three coordinator and four-room configs use degree-2 Legendre
collocation, N=8 and a step every 300 s, as their sources do.

Each takes a ``solver`` dict merged over its solver options (for example
``{"kkt_method": "ldl"}``). Run them with
``LocalMAS(configs, env={"rt": False}, device="cpu", dtype=torch.float64)``
(``agentlib_mpc_torch.runtime.mas``), or on the card with the default
``device``.
"""

from __future__ import annotations

import numpy as np

from agentlib_mpc_torch.models.ml_model import MLModel
from agentlib_mpc_torch.models.model import Model, ModelEquations
from agentlib_mpc_torch.models.objective import SubObjective
from agentlib_mpc_torch.models.variables import (
    Var,
    control_input,
    output,
    parameter,
    state,
)
from agentlib_mpc_torch.models.zoo import OneRoom

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


#: examples/mhe_one_room.py: controller step (s), comfort bound and start
#: temperature (K), the plant's true heat load and the controller's first
#: guess (W)
MHE_DT, MHE_UB, MHE_START = 120.0, 295.15, 298.16
MHE_TRUE_LOAD, MHE_GUESS_LOAD = 260.0, 100.0


class RoomLoadParam(Model):
    """examples/mhe_one_room.py's one-room cooling model with the heat load
    as a *parameter*, so the MHE can estimate it (it becomes a
    zero-dynamics state in the MHE OCP, reference
    ``casadi_/mhe.py:34-123``)."""

    inputs = [
        control_input("mDot", 0.0225, lb=0.0, ub=0.05, unit="m^3/s"),
        control_input("T_in", 290.15, unit="K"),
        control_input("T_upper", MHE_UB, unit="K"),
    ]
    states = [
        state("T", 293.15, lb=288.15, ub=303.15, unit="K"),
        state("T_slack", 0.0, unit="K"),
    ]
    parameters = [
        parameter("cp", 1000.0),
        parameter("C", 100000.0),
        Var(name="load", value=150.0, lb=0.0, ub=500.0, unit="W",
            role="parameter"),
        parameter("s_T", 1.0),
        parameter("r_mDot", 0.1),
    ]
    outputs = [output("T_out", unit="K")]

    def setup(self, v):
        eq = ModelEquations()
        eq.ode("T", v.cp * v.mDot / v.C * (v.T_in - v.T) + v.load / v.C)
        eq.alg("T_out", v.T)
        eq.constraint(0.0, v.T + v.T_slack, v.T_upper)
        eq.objective = (
            SubObjective(v.mDot, weight=v.r_mDot, name="control_costs")
            + SubObjective(v.T_slack ** 2, weight=v.s_T, name="temp_slack")
        )
        return eq


def mhe_one_room_configs(horizon: int = 10, solver: dict | None = None):
    """examples/mhe_one_room.py's controller (MHE beside MPC) and plant."""
    solver = {"max_iter": 50, **(solver or {})}
    controller = {
        "id": "Controller",
        "modules": [
            {"module_id": "com", "type": "local_broadcast"},
            {"module_id": "mhe", "type": "mhe",
             "optimization_backend": {
                 "type": "jax_mhe",
                 "model": {"class": RoomLoadParam},
                 "discretization_options": {"collocation_order": 2},
                 "solver": dict(solver),
             },
             "time_step": MHE_DT,
             "horizon": horizon,
             "state_weights": {"T": 1.0},
             "states": [
                 {"name": "T", "value": MHE_START, "alias": "T",
                  "source": "Plant"},
             ],
             "known_inputs": [
                 {"name": "mDot", "value": 0.02, "alias": "mDot"},
                 {"name": "T_in", "value": 290.15},
                 {"name": "T_upper", "value": MHE_UB},
             ],
             "estimated_parameters": [
                 {"name": "load", "value": MHE_GUESS_LOAD, "lb": 0.0,
                  "ub": 500.0, "alias": "load_estimate"},
             ]},
            {"module_id": "mpc", "type": "mpc",
             "optimization_backend": {
                 "type": "jax",
                 "model": {"class": RoomLoadParam},
                 "discretization_options": {"collocation_order": 2},
                 "solver": dict(solver),
             },
             "time_step": MHE_DT,
             "prediction_horizon": horizon,
             "parameters": [
                 {"name": "load", "value": MHE_GUESS_LOAD,
                  "alias": "load_estimate", "source": "Controller"},
                 {"name": "s_T", "value": 1.0},
                 {"name": "r_mDot", "value": 0.1},
             ],
             "inputs": [
                 {"name": "T_in", "value": 290.15},
                 {"name": "T_upper", "value": MHE_UB},
             ],
             "controls": [
                 {"name": "mDot", "value": 0.02, "ub": 0.05, "lb": 0.0,
                  "alias": "mDot"},
             ],
             "states": [
                 {"name": "T", "value": MHE_START, "ub": 303.15,
                  "lb": 288.15, "alias": "T", "source": "Plant"},
             ]},
        ],
    }
    plant = {
        "id": "Plant",
        "modules": [
            {"module_id": "com", "type": "local_broadcast"},
            {"module_id": "room", "type": "simulator",
             "model": {"class": RoomLoadParam,
                       "states": [{"name": "T", "value": MHE_START}],
                       "parameters": [{"name": "load",
                                       "value": MHE_TRUE_LOAD}]},
             "t_sample": 60,
             "outputs": [{"name": "T_out", "value": MHE_START,
                          "alias": "T"}],
             "inputs": [{"name": "mDot", "value": 0.02, "alias": "mDot"}]},
        ],
    }
    return [controller, plant]


class RoomWithLoadParam(OneRoom):
    """tests/test_mhe.py's OneRoom variant with the heat load as a
    *parameter* so the MHE can estimate it (the reference estimates
    parameters the same way, ``mhe.py:70-79``)."""

    inputs = [v for v in OneRoom.inputs if v.name != "load"]
    parameters = list(OneRoom.parameters) + [
        Var(name="load", value=150.0, lb=0.0, ub=500.0, role="parameter"),
    ]


def mhe_estimator_configs(solver: dict | None = None):
    """tests/test_mhe.py's estimator agent and plant (true load 260 W, a
    step every 60 s, horizon 8)."""
    estimator = {
        "id": "Estimator",
        "modules": [
            {"module_id": "com", "type": "local_broadcast"},
            {
                "module_id": "mhe",
                "type": "mhe",
                "optimization_backend": {
                    "type": "jax_mhe",
                    "model": {"class": RoomWithLoadParam},
                    "discretization_options": {"collocation_order": 2},
                    "solver": {"max_iter": 50, **(solver or {})},
                },
                "time_step": 60.0,
                "horizon": 8,
                "state_weights": {"T": 1.0},
                "states": [
                    {"name": "T", "value": 298.16, "alias": "T",
                     "source": "Plant"},
                ],
                "known_inputs": [
                    {"name": "mDot", "value": 0.02, "alias": "mDot",
                     "source": "Plant"},
                    {"name": "T_in", "value": 290.15},
                    {"name": "T_upper", "value": 295.15},
                ],
                "estimated_parameters": [
                    {"name": "load", "value": 100.0, "lb": 0.0,
                     "ub": 500.0},
                ],
            },
        ],
    }
    plant = {
        "id": "Plant",
        "modules": [
            {"module_id": "com", "type": "local_broadcast"},
            {
                "module_id": "room",
                "type": "simulator",
                "model": {"class": RoomWithLoadParam,
                          "states": [{"name": "T", "value": 298.16}],
                          "parameters": [{"name": "load",
                                          "value": MHE_TRUE_LOAD}]},
                "t_sample": 60.0,
                "outputs": [{"name": "T_out", "value": 298.16,
                             "alias": "T"}],
                "inputs": [{"name": "mDot", "value": 0.02, "alias": "mDot",
                            "shared": True}],
            },
        ],
    }
    return [estimator, plant]


#: examples/minlp_switched_room.py: controller step (s), start temperature
#: and comfort bound (K)
MINLP_DT, MINLP_START, MINLP_UB = 300.0, 297.15, 295.15


def switched_room_backend_config(backend_type: str = "jax_cia",
                                 solver: dict | None = None,
                                 **extra) -> dict:
    """The SwitchedRoom backend of examples/minlp_switched_room.py and
    tests/test_minlp.py (multiple shooting, budget 60); ``extra`` adds
    keys such as ``cia_options``, ``bb_options`` or ``binary_method``."""
    return {"type": backend_type,
            "model": {"class": "SwitchedRoom"},
            "discretization_options": {"method": "multiple_shooting"},
            "solver": {"max_iter": 60, **(solver or {})},
            **extra}


def minlp_switched_room_configs(prediction_horizon: int = 8,
                                backend_type: str = "jax_cia",
                                solver: dict | None = None):
    """examples/minlp_switched_room.py's controller (``minlp_mpc``) and
    plant; ``backend_type`` "jax_cia" or "jax_minlp_bb"."""
    if backend_type == "jax_minlp_bb":
        # exact search over the unconstrained-switching MINLP (the
        # switch budget is a CIA concept)
        extra = {"bb_options": {"max_nodes": 48, "batch_pairs": 4}}
    else:
        extra = {"cia_options": {"max_switches": 6}}
    backend = switched_room_backend_config(backend_type, solver, **extra)
    controller = {
        "id": "Controller",
        "modules": [
            {"module_id": "com", "type": "local_broadcast"},
            {"module_id": "mpc", "type": "minlp_mpc",
             "optimization_backend": backend,
             "time_step": MINLP_DT,
             "prediction_horizon": prediction_horizon,
             "inputs": [{"name": "load", "value": 180.0},
                        {"name": "T_upper", "value": MINLP_UB}],
             "binary_controls": [{"name": "on", "value": 0,
                                  "lb": 0, "ub": 1}],
             "states": [{"name": "T", "value": MINLP_START, "alias": "T",
                         "source": "Plant"}],
             "outputs": [{"name": "T_out", "shared": False}],
             "parameters": []},
        ],
    }
    plant = {
        "id": "Plant",
        "modules": [
            {"module_id": "com", "type": "local_broadcast"},
            {"module_id": "room", "type": "simulator",
             "model": {"class": "SwitchedRoom",
                       "states": [{"name": "T", "value": MINLP_START}]},
             "t_sample": 60,
             "inputs": [{"name": "on", "alias": "on"}],
             "outputs": [{"name": "T_out", "alias": "T"}]},
        ],
    }
    return [controller, plant]


#: examples/admm_cooled_room.py: comfort bound, controller step (s) and
#: start temperature (K)
ADMM_UB, ADMM_DT, ADMM_START = 295.15, 300.0, 298.16


def _admm_backend(model: str, solver: dict | None, **extra) -> dict:
    return {"type": "jax_admm", "model": {"class": model}, **extra,
            "solver": {"max_iter": 40, **(solver or {})}}


def admm_cooled_room_configs(prediction_horizon: int = 8,
                             max_iterations: int = 6,
                             penalty_factor: float = 10.0,
                             solver: dict | None = None):
    """examples/admm_cooled_room.py's room, cooler and simulator."""
    disc = {"discretization_options": {"collocation_order": 2,
                                       "collocation_method": "legendre"}}
    admm = {"module_id": "admm", "type": "admm_local",
            "time_step": ADMM_DT,
            "prediction_horizon": prediction_horizon,
            "max_iterations": max_iterations,
            "penalty_factor": penalty_factor}
    room = {
        "id": "CooledRoom",
        "modules": [
            {"module_id": "com", "type": "local_broadcast"},
            {**admm,
             "optimization_backend": _admm_backend("CooledRoom", solver,
                                                   **disc),
             "parameters": [{"name": "s_T", "value": 1.0}],
             "inputs": [
                 {"name": "load", "value": 150},
                 {"name": "T_in", "value": 290.15},
                 {"name": "T_upper", "value": ADMM_UB},
             ],
             "controls": [],
             "states": [
                 {"name": "T", "value": ADMM_START, "ub": 303.15,
                  "lb": 288.15, "alias": "T", "source": "Simulation"},
             ],
             "couplings": [
                 {"name": "mDot", "alias": "mDotCoolAir", "value": 0.02,
                  "ub": 0.05, "lb": 0.0},
             ]},
        ],
    }
    cooler = {
        "id": "Cooler",
        "modules": [
            {"module_id": "com", "type": "local_broadcast"},
            {**admm,
             "optimization_backend": _admm_backend("Cooler", solver,
                                                   **disc),
             "parameters": [{"name": "r_mDot", "value": 1.0}],
             "controls": [
                 {"name": "mDot", "value": 0.02, "ub": 0.05, "lb": 0.0},
             ],
             "couplings": [
                 {"name": "mDot_out", "alias": "mDotCoolAir",
                  "value": 0.02},
             ]},
        ],
    }
    sim = {
        "id": "Simulation",
        "modules": [
            {"module_id": "com", "type": "local_broadcast"},
            {"module_id": "simulator", "type": "simulator",
             "model": {"class": "CooledRoom",
                       "states": [{"name": "T", "value": ADMM_START}]},
             "t_sample": 60,
             "outputs": [{"name": "T_out", "value": ADMM_START,
                          "alias": "T"}],
             "inputs": [{"name": "mDot", "value": 0.02, "alias": "mDot"}]},
        ],
    }
    return [room, cooler, sim]


def admm_realtime_pair_configs(solver: dict | None = None):
    """tests/test_admm_realtime.py's wall-clock room and cooler."""

    def agent(aid, model, couplings, controls, extra):
        backend = {"type": "jax_admm", "model": {"class": model},
                   "discretization_options": {"collocation_order": 2},
                   "solver": {"max_iter": 25, **(solver or {})},
                   "precompile": True}
        return {"id": aid, "modules": [
            {"module_id": "com", "type": "local_broadcast"},
            {"module_id": "admm", "type": "admm",
             "optimization_backend": backend,
             "time_step": 8.0, "prediction_horizon": 4,
             "max_iterations": 3, "iteration_timeout": 5.0,
             "registration_period": 0.3, "penalty_factor": 10.0,
             "couplings": couplings, "controls": controls, **extra},
        ]}

    room = agent(
        "Room", "CooledRoom",
        couplings=[{"name": "mDot", "alias": "air", "value": 0.02,
                    "ub": 0.05, "lb": 0.0}],
        controls=[],
        extra={"inputs": [{"name": "load", "value": 150},
                          {"name": "T_in", "value": 290.15},
                          {"name": "T_upper", "value": 295.15}],
               "states": [{"name": "T", "value": 298.16}]})
    cooler = agent(
        "Cooler", "Cooler",
        couplings=[{"name": "mDot_out", "alias": "air", "value": 0.02}],
        controls=[{"name": "mDot", "value": 0.02, "ub": 0.05, "lb": 0.0}],
        extra={"parameters": [{"name": "r_mDot", "value": 1.0}]})
    return [room, cooler]


def coordinator_pair_configs(solver: dict | None = None):
    """tests/test_coordinator.py's coordinator, room, cooler and
    simulator."""
    coordinator = {
        "id": "Coordinator",
        "modules": [
            {"module_id": "com", "type": "local_broadcast"},
            {"module_id": "coordinator", "type": "admm_coordinator",
             "time_step": ADMM_DT, "prediction_horizon": 8,
             "admm_iter_max": 12, "penalty_factor": 10.0,
             "abs_tol": 1e-4, "rel_tol": 1e-3,
             "penalty_change_threshold": 10.0},
        ],
    }

    def employee(aid, model, couplings, controls, extra):
        backend = _admm_backend(model, solver, discretization_options={
            "collocation_order": 2, "collocation_method": "legendre"})
        return {"id": aid, "modules": [
            {"module_id": "com", "type": "local_broadcast"},
            {"module_id": "admm", "type": "admm_coordinated",
             "coordinator": "Coordinator", "registration_interval": 30.0,
             "optimization_backend": backend, "time_step": ADMM_DT,
             "prediction_horizon": 8, "couplings": couplings,
             "controls": controls, **extra},
        ]}

    room = employee(
        "CooledRoom", "CooledRoom",
        couplings=[{"name": "mDot", "alias": "mDotCoolAir", "value": 0.02,
                    "ub": 0.05, "lb": 0.0}],
        controls=[],
        extra={"inputs": [{"name": "load", "value": 150},
                          {"name": "T_in", "value": 290.15},
                          {"name": "T_upper", "value": ADMM_UB}],
               "states": [{"name": "T", "value": ADMM_START, "ub": 303.15,
                           "lb": 288.15, "alias": "T",
                           "source": "Simulation"}],
               "parameters": [{"name": "s_T", "value": 1.0}]})
    cooler = employee(
        "Cooler", "Cooler",
        couplings=[{"name": "mDot_out", "alias": "mDotCoolAir",
                    "value": 0.02}],
        controls=[{"name": "mDot", "value": 0.02, "ub": 0.05, "lb": 0.0}],
        extra={"parameters": [{"name": "r_mDot", "value": 1.0}]})
    sim = {
        "id": "Simulation",
        "modules": [
            {"module_id": "com", "type": "local_broadcast"},
            {"module_id": "simulator", "type": "simulator",
             "model": {"class": "CooledRoom",
                       "states": [{"name": "T", "value": ADMM_START}]},
             "t_sample": 60,
             "outputs": [{"name": "T_out", "value": ADMM_START,
                          "alias": "T"}],
             "inputs": [{"name": "mDot", "value": 0.02, "alias": "mDot"}]},
        ],
    }
    return [coordinator, room, cooler, sim]


#: examples/admm_4rooms_coordinator.py and examples/exchange_admm_4rooms.py:
#: the rooms' heat loads (W), comfort bound and start temperature (K), the
#: AHU's shared capacity (m³/s) and the exchange alias
FOUR_ROOM_LOADS = (80.0, 110.0, 140.0, 170.0)
FOUR_ROOM_UB, FOUR_ROOM_START = 295.15, 298.16
AHU_CAPACITY = 0.075
EXCHANGE_ALIAS = "air_balance"


def _four_room_backend(model: str, solver: dict | None) -> dict:
    return {"type": "jax_admm", "model": {"class": model},
            "discretization_options": {"collocation_order": 2,
                                       "collocation_method": "legendre"},
            "solver": {"max_iter": 60, **(solver or {})}}


def _four_room_sim(i: int, model: str) -> dict:
    return {
        "id": f"Simulation_{i}",
        "modules": [
            {"module_id": "com", "type": "local_broadcast"},
            {"module_id": "simulator", "type": "simulator",
             "model": {"class": model,
                       "states": [{"name": "T", "value": FOUR_ROOM_START}],
                       "inputs": [{"name": "load",
                                   "value": FOUR_ROOM_LOADS[i - 1]}]},
             "t_sample": 60,
             "outputs": [{"name": "T_out", "value": FOUR_ROOM_START,
                          "alias": f"T_{i}"}],
             "inputs": [{"name": "mDot", "value": 0.02,
                         "alias": f"mDot_{i}"}]},
        ],
    }


def _four_room_inputs(i: int) -> dict:
    return {
        "parameters": [{"name": "s_T", "value": 1.0}],
        "inputs": [{"name": "load", "value": FOUR_ROOM_LOADS[i - 1]},
                   {"name": "T_in", "value": 290.15},
                   {"name": "T_upper", "value": FOUR_ROOM_UB}],
        "states": [{"name": "T", "value": FOUR_ROOM_START, "ub": 303.15,
                    "lb": 288.15, "alias": f"T_{i}",
                    "source": f"Simulation_{i}"}],
    }


def admm_4rooms_coordinator_configs(admm_iter_max: int = 15,
                                    penalty_factor: float = 10.0,
                                    solver: dict | None = None):
    """examples/admm_4rooms_coordinator.py's coordinator, four rooms, AHU
    and four simulators."""
    coordinator = {
        "id": "Coordinator",
        "modules": [
            {"module_id": "com", "type": "local_broadcast"},
            {"module_id": "coordinator", "type": "admm_coordinator",
             "time_step": ADMM_DT, "prediction_horizon": 8,
             "admm_iter_max": admm_iter_max,
             "penalty_factor": penalty_factor,
             "abs_tol": 1e-4, "rel_tol": 1e-3,
             "penalty_change_threshold": 10.0},
        ],
    }
    participant = {"module_id": "admm", "type": "admm_coordinated",
                   "coordinator": "Coordinator",
                   "registration_interval": 30.0, "time_step": ADMM_DT,
                   "prediction_horizon": 8}
    rooms = [{
        "id": f"Room_{i}",
        "modules": [
            {"module_id": "com", "type": "local_broadcast"},
            {**participant,
             "optimization_backend": _four_room_backend("CooledRoom",
                                                        solver),
             **_four_room_inputs(i),
             "controls": [],
             "couplings": [{"name": "mDot", "alias": f"mDotCoolAir_{i}",
                            "value": 0.02, "ub": 0.05, "lb": 0.0}]},
        ],
    } for i in range(1, 5)]
    ahu = {
        "id": "AHU",
        "modules": [
            {"module_id": "com", "type": "local_broadcast"},
            {**participant,
             "optimization_backend": _four_room_backend("AirHandlingUnit",
                                                        solver),
             "parameters": [{"name": "r_mDot", "value": 1.0},
                            {"name": "mDot_max", "value": AHU_CAPACITY}],
             "controls": [{"name": f"mDot_{i}", "value": 0.02, "ub": 0.05,
                           "lb": 0.0, "alias": f"mDot_{i}"}
                          for i in range(1, 5)],
             "couplings": [{"name": f"mDot_out_{i}",
                            "alias": f"mDotCoolAir_{i}", "value": 0.02}
                           for i in range(1, 5)]},
        ],
    }
    sims = [_four_room_sim(i, "CooledRoom") for i in range(1, 5)]
    return [coordinator, *rooms, ahu, *sims]


def exchange_admm_4rooms_configs(max_iterations: int = 12,
                                 penalty_factor: float = 50.0,
                                 rooms=(1, 2, 3, 4),
                                 solver: dict | None = None):
    """examples/exchange_admm_4rooms.py's rooms, supplier and simulators
    (the rooms numbered in ``rooms``)."""
    admm = {"module_id": "admm", "type": "admm_local", "time_step": ADMM_DT,
            "prediction_horizon": 8, "max_iterations": max_iterations,
            "penalty_factor": penalty_factor}
    agents = [{
        "id": f"Room_{i}",
        "modules": [
            {"module_id": "com", "type": "local_broadcast"},
            {**admm,
             "optimization_backend": _four_room_backend("ExchangeRoom",
                                                        solver),
             **_four_room_inputs(i),
             "controls": [{"name": "mDot", "value": 0.02, "ub": 0.05,
                           "lb": 0.0, "alias": f"mDot_{i}"}],
             "exchange": [{"name": "mDot_out", "alias": EXCHANGE_ALIAS,
                           "value": 0.02, "ub": 0.05, "lb": 0.0}]},
        ],
    } for i in rooms]
    supplier = {
        "id": "Supplier",
        "modules": [
            {"module_id": "com", "type": "local_broadcast"},
            {**admm,
             "optimization_backend": _four_room_backend("AirSupplier",
                                                        solver),
             "parameters": [{"name": "r_mDot", "value": 1.0}],
             "controls": [{"name": "mDot", "value": 0.08, "ub": 0.2,
                           "lb": 0.0, "alias": "mDot_supply"}],
             "exchange": [{"name": "mDot_net", "alias": EXCHANGE_ALIAS,
                           "value": -0.08, "ub": 0.0, "lb": -0.2}]},
        ],
    }
    sims = [_four_room_sim(i, "ExchangeRoom") for i in rooms]
    return [*agents, supplier, *sims]


# -- the data-driven examples ------------------------------------------------

#: examples/ml_mpc_one_room.py: step (s), capacity (J/K), heat load (W) and
#: comfort bound (K)
ML_DT, ML_C_CAP, ML_LOAD, ML_UB = 300.0, 100000.0, 180.0, 295.15


def ml_room_plant_step(T: float, Q: float) -> float:
    """The example's 'real' building (first-order energy balance)."""
    return float(np.clip(T + ML_DT / ML_C_CAP * (ML_LOAD - Q), 285.0,
                         310.0))


def ml_room_training_data(n_steps: int = 500, seed: int = 0):
    """The example's excitation data: uniform random heat flows."""
    import pandas as pd

    rng = np.random.default_rng(seed)
    T, rows = 296.0, []
    for k in range(n_steps):
        Q = float(rng.uniform(0.0, 1000.0))
        rows.append((k * ML_DT, Q, T))
        T = ml_room_plant_step(T, Q)
    return pd.DataFrame(rows, columns=["t", "Q", "T"]).set_index("t")


def _train_narx(df, dt, u_name, epochs, seed, split_seed, device, dtype,
                return_data=False):
    """The examples' pipeline: (u, T) -> dT, difference mode, recursive,
    hidden (16, 16), lr 3e-3."""
    from agentlib_mpc_torch.ml.serialized import Feature, OutputFeature
    from agentlib_mpc_torch.ml.training import (
        ANNTrainerCore,
        create_lagged_features,
        fit_ann,
        resample,
        train_val_test_split,
    )

    inputs = {u_name: Feature(name=u_name, lag=1)}
    output = {"T": OutputFeature(name="T", output_type="difference",
                                 recursive=True)}
    X, y = create_lagged_features(resample(df, dt, method="previous"),
                                  inputs, output)
    data = train_val_test_split(X, y, (0.7, 0.15, 0.15), seed=split_seed)
    doc = fit_ann(data.training_inputs, data.training_outputs,
                  data.validation_inputs, data.validation_outputs,
                  dt=dt, inputs=inputs, output=output,
                  trainer=ANNTrainerCore(hidden=(16, 16), epochs=epochs,
                                         learning_rate=3e-3, seed=seed,
                                         device=device, dtype=dtype))
    return (doc, data) if return_data else doc


def train_room_surrogate(df, epochs: int = 300, device=None,
                         dtype=None, return_data: bool = False):
    """examples/ml_mpc_one_room.py's ``train_surrogate`` on ``device``
    (None: the card) in ``dtype`` (None: float64); with ``return_data``
    also the train/validation/test split it trained on."""
    import torch

    return _train_narx(df, ML_DT, "Q", epochs, 0, 0, device,
                       dtype or torch.float64, return_data)


def ml_mpc_backend_config(surrogate, solver: dict | None = None) -> dict:
    """The example's ``jax_ml`` backend config (``max_iter`` 60)."""
    return {"type": "jax_ml",
            "model": {"class": SurrogateRoom, "ml_model_sources": [surrogate]},
            "solver": {"max_iter": 60, **(solver or {})}}


class SurrogateRoom(MLModel):
    """examples/ml_mpc_one_room.py's model: ``T`` from the surrogate, a
    soft comfort bound and an energy cost."""

    inputs = [control_input("Q", 0.0, lb=0.0, ub=1000.0, unit="W"),
              control_input("T_upper", ML_UB)]
    states = [state("T", 296.0, lb=285.15, ub=310.15),
              state("T_slack", 0.0)]
    parameters = [parameter("s_T", 1.0), parameter("r_Q", 1e-4)]
    dt = ML_DT

    def setup(self, v):
        eq = ModelEquations()
        eq.constraint(0.0, v.T + v.T_slack, v.T_upper)
        eq.objective = (
            SubObjective(v.Q, weight=v.r_Q, name="energy")
            + SubObjective(v.T_slack ** 2, weight=v.s_T, name="comfort"))
        return eq


#: examples/three_zone_datadriven_admm.py: zones, horizon, comfort bound,
#: start and supply temperature (K), heat capacity terms, the zones' loads
#: (W) and the AHU's shared capacity (m³/s)
ZONES_N, ZONES_HORIZON = 3, 8
ZONES_UB, ZONES_START, ZONES_T_IN = 295.15, 298.16, 290.15
ZONES_CP, ZONES_C_CAP = 1000.0, 100000.0
ZONES_LOADS = (90.0, 130.0, 170.0)
ZONES_MDOT_MAX = 0.075


def zone_plant_step(T: float, mDot: float, load: float) -> float:
    """The example's 'true' zone (explicit Euler on the control grid)."""
    return float(T + ML_DT * (ZONES_CP * mDot / ZONES_C_CAP
                              * (ZONES_T_IN - T) + load / ZONES_C_CAP))


def zone_training_data(load: float, seed: int = 0):
    """The example's excitation data of one zone: 400 random flows."""
    import pandas as pd

    rng = np.random.default_rng(seed)
    T, rows = 296.0, []
    for k in range(400):
        mDot = float(rng.uniform(0.0, 0.05))
        rows.append((k * ML_DT, mDot, T))
        T = zone_plant_step(T, mDot, load)
    return pd.DataFrame(rows, columns=["t", "mDot", "T"]).set_index("t")


def train_zone_surrogate(load: float, epochs: int = 300, seed: int = 0,
                         device=None, dtype=None,
                         return_data: bool = False):
    """examples/three_zone_datadriven_admm.py's ``train_zone_surrogate``
    on ``device`` (None: the card) in ``dtype`` (None: float64)."""
    import torch

    return _train_narx(zone_training_data(load, seed), ML_DT, "mDot",
                       epochs, 0, seed, device, dtype or torch.float64,
                       return_data)


class ZoneSurrogate(MLModel):
    """The example's zone: ``T`` from the surrogate, the comfort bound and
    objective declarative."""

    inputs = [
        control_input("mDot", 0.02, lb=0.0, ub=0.05, unit="m^3/s"),
        control_input("T_upper", ZONES_UB),
    ]
    states = [
        state("T", 296.0, lb=285.15, ub=310.15),
        state("T_slack", 0.0),
    ]
    parameters = [parameter("s_T", 1.0)]
    dt = ML_DT

    def setup(self, v):
        eq = ModelEquations()
        eq.constraint(0.0, v.T + v.T_slack, v.T_upper)
        eq.objective = SubObjective(v.T_slack ** 2, weight=v.s_T,
                                    name="comfort")
        return eq


class ThreePortAHU(Model):
    """The example's AHU: three outlets under one shared capacity."""

    inputs = [
        control_input(f"mDot_{i}", 0.02, lb=0.0, ub=0.05, unit="m^3/s")
        for i in range(1, ZONES_N + 1)
    ]
    parameters = [
        parameter("mDot_max", ZONES_MDOT_MAX),
        parameter("r_mDot", 1.0),
    ]
    outputs = [output(f"mDot_out_{i}", 0.02, unit="m^3/s")
               for i in range(1, ZONES_N + 1)]

    def setup(self, v):
        eq = ModelEquations()
        total = v.mDot_1 + v.mDot_2 + v.mDot_3
        for i in range(1, ZONES_N + 1):
            eq.alg(f"mDot_out_{i}", getattr(v, f"mDot_{i}"))
        eq.constraint(0.0, total, v.mDot_max)
        eq.objective = SubObjective(total, weight=v.r_mDot,
                                    name="flow_costs")
        return eq


def three_zone_datadriven_configs(surrogates, max_iterations: int = 10,
                                  penalty_factor: float = 20.0,
                                  solver: dict | None = None):
    """The example's ``agent_configs``: three zones, the AHU and three
    simulated ``CooledRoom`` plants."""
    solver = {"max_iter": 60, **(solver or {})}
    zones, sims = [], []
    for i in range(1, ZONES_N + 1):
        zones.append({
            "id": f"Zone_{i}",
            "modules": [
                {"module_id": "com", "type": "local_broadcast"},
                {"module_id": "admm", "type": "admm_local",
                 "optimization_backend": {
                     "type": "jax_admm_ml",
                     "model": {"class": ZoneSurrogate,
                               "ml_model_sources": [surrogates[i - 1]]},
                     "solver": dict(solver),
                 },
                 "time_step": ML_DT,
                 "prediction_horizon": ZONES_HORIZON,
                 "max_iterations": max_iterations,
                 "penalty_factor": penalty_factor,
                 "parameters": [{"name": "s_T", "value": 1.0}],
                 "inputs": [{"name": "T_upper", "value": ZONES_UB}],
                 "states": [
                     {"name": "T", "value": ZONES_START, "ub": 310.15,
                      "lb": 285.15, "alias": f"T_{i}",
                      "source": f"Simulation_{i}"},
                 ],
                 "controls": [],
                 "couplings": [
                     {"name": "mDot", "alias": f"air_{i}", "value": 0.02,
                      "ub": 0.05, "lb": 0.0},
                 ]},
            ],
        })
        sims.append({
            "id": f"Simulation_{i}",
            "modules": [
                {"module_id": "com", "type": "local_broadcast"},
                {"module_id": "simulator", "type": "simulator",
                 "model": {"class": "CooledRoom",
                           "states": [{"name": "T", "value": ZONES_START}],
                           "inputs": [{"name": "load",
                                       "value": ZONES_LOADS[i - 1]}]},
                 "t_sample": 60,
                 "outputs": [{"name": "T_out", "value": ZONES_START,
                              "alias": f"T_{i}"}],
                 "inputs": [{"name": "mDot", "value": 0.02,
                             "alias": f"mDot_{i}"}]},
            ],
        })
    ahu = {
        "id": "AHU",
        "modules": [
            {"module_id": "com", "type": "local_broadcast"},
            {"module_id": "admm", "type": "admm_local",
             "optimization_backend": {
                 "type": "jax_admm",
                 "model": {"class": ThreePortAHU},
                 "discretization_options": {"collocation_order": 1},
                 "solver": dict(solver),
             },
             "time_step": ML_DT,
             "prediction_horizon": ZONES_HORIZON,
             "max_iterations": max_iterations,
             "penalty_factor": penalty_factor,
             "parameters": [{"name": "r_mDot", "value": 1.0},
                            {"name": "mDot_max", "value": ZONES_MDOT_MAX}],
             "controls": [
                 {"name": f"mDot_{i}", "value": 0.02, "ub": 0.05,
                  "lb": 0.0, "alias": f"mDot_{i}"}
                 for i in range(1, ZONES_N + 1)
             ],
             "couplings": [
                 {"name": f"mDot_out_{i}", "alias": f"air_{i}",
                  "value": 0.02}
                 for i in range(1, ZONES_N + 1)
             ]},
        ],
    }
    return [*zones, ahu, *sims]


class _Tracker(Model):
    """A one-control tracker, min (u − a)²."""

    inputs = [control_input("u", 0.0, lb=-5.0, ub=5.0)]
    parameters = [parameter("a", 1.0)]

    def setup(self, v):
        eq = ModelEquations()
        eq.objective = SubObjective((v.u - v.a) ** 2, name="track")
        return eq


def tracker_ocp():
    """The JAX package's gate workload (``agentlib_mpc_tpu/lint/
    retrace_budget.py:104-124``): the one-control tracker on a 4-interval
    multiple-shooting grid (dt 0.5), transcribed by the port. Structurally
    the consensus bench agents' shape; solves in milliseconds."""
    from agentlib_mpc_torch.ops.transcription import transcribe

    return transcribe(_Tracker(), ["u"], N=4, dt=0.5,
                      method="multiple_shooting")
