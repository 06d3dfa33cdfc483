"""Built-in example models ("model zoo").

Copy of ``agentlib_mpc_tpu/models/zoo.py`` with the imports rebound to
the port; the ``setup`` bodies are plain arithmetic on ``v.*`` and run
unchanged on torch tensors.

Native re-designs of the dynamics used across the reference's example
families (``examples/one_room_mpc/physical/simple_mpc.py:27-138``,
``examples/admm/models/{ca_room_model,ca_cooler_model}.py``): single-zone
cooling, the cooled-room / cooler pair coupled through an air mass flow
(the consensus-ADMM benchmark topology), and a synthetic N-zone building
for scale-out benchmarks. The physics is the standard 1R1C air-volume
energy balance:

    dT/dt = cp * mDot / C * (T_in - T) + load / C

All models are plain :class:`~agentlib_mpc_torch.models.model.Model`
subclasses — pure tensor arithmetic, safe under ``torch.func`` transforms.
"""

from __future__ import annotations

from agentlib_mpc_torch.models.model import Model, ModelEquations
from agentlib_mpc_torch.models.objective import SubObjective
from agentlib_mpc_torch.models.variables import (
    control_input,
    output,
    parameter,
    state,
)


class OneRoom(Model):
    """Flagship single-zone cooling model (central MPC).

    Air-volume zone with soft comfort constraint ``T + s <= T_upper`` and
    cost ``r_mDot * mDot + s_T * s**2`` — the reference's one-room example
    (``examples/one_room_mpc/physical/simple_mpc.py:27-138``).
    """

    inputs = [
        control_input("mDot", 0.0225, lb=0.0, ub=0.05, unit="m^3/s",
                      description="cooling air mass flow (control)"),
        control_input("load", 150.0, unit="W", description="heat load"),
        control_input("T_in", 290.15, unit="K",
                      description="inflow air temperature"),
        control_input("T_upper", 294.15, unit="K",
                      description="soft upper comfort bound"),
    ]
    states = [
        state("T", 293.15, lb=288.15, ub=303.15, unit="K",
              description="zone temperature"),
        state("T_slack", 0.0, unit="K", description="comfort slack"),
    ]
    parameters = [
        parameter("cp", 1000.0, unit="J/kg*K"),
        parameter("C", 100000.0, unit="J/K"),
        parameter("s_T", 1.0, description="slack weight"),
        parameter("r_mDot", 1.0, description="air flow cost weight"),
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


class CooledRoom(Model):
    """Room half of the ADMM pair: ``mDot`` is a *coupling* input the room
    optimizes locally but must agree on with the cooler (reference
    ``examples/admm/models/ca_room_model.py``). The room pays only for
    comfort (slack), not for the air it requests.
    """

    inputs = [
        control_input("mDot", 0.0225, lb=0.0, ub=0.05, unit="m^3/s",
                      description="air mass flow into the zone (coupling)"),
        control_input("load", 150.0, unit="W"),
        control_input("T_in", 290.15, unit="K"),
        control_input("T_upper", 294.15, unit="K"),
    ]
    states = [
        state("T", 293.15, lb=288.15, ub=303.15, unit="K"),
        state("T_slack", 0.0, unit="K"),
    ]
    parameters = [
        parameter("cp", 1000.0),
        parameter("C", 100000.0),
        parameter("s_T", 1.0),
    ]
    outputs = [output("T_out", unit="K")]

    def setup(self, v):
        eq = ModelEquations()
        eq.ode("T", v.cp * v.mDot / v.C * (v.T_in - v.T) + v.load / v.C)
        eq.alg("T_out", v.T)
        eq.constraint(0.0, v.T + v.T_slack, v.T_upper)
        eq.objective = SubObjective(v.T_slack ** 2, weight=v.s_T,
                                    name="temp_slack")
        return eq


class Cooler(Model):
    """Cooler half of the ADMM pair: purely static, supplies ``mDot`` at
    cost ``r_mDot * mDot`` (reference ``ca_cooler_model.py``)."""

    inputs = [
        control_input("mDot", 0.0225, lb=0.0, ub=0.05, unit="m^3/s",
                      description="air mass flow out of the cooler"),
    ]
    parameters = [parameter("r_mDot", 1.0)]
    outputs = [output("mDot_out", 0.0225, unit="m^3/s")]

    def setup(self, v):
        eq = ModelEquations()
        eq.alg("mDot_out", v.mDot)
        eq.objective = SubObjective(v.mDot, weight=v.r_mDot,
                                    name="control_costs")
        return eq


class ZoneWithSupply(Model):
    """Synthetic scale-out zone: a cooled room that also pays for its air
    request — the per-zone subproblem of the N-zone exchange-ADMM benchmark
    (BASELINE.json "synthetic 256-zone building"). Zones differ only in
    their ``load``/``C`` parameters, so N of them vmap into one batch.
    """

    inputs = [
        control_input("mDot", 0.0225, lb=0.0, ub=0.05, unit="m^3/s",
                      description="air mass flow (exchange coupling)"),
        control_input("load", 150.0, unit="W"),
        control_input("T_in", 290.15, unit="K"),
        control_input("T_upper", 294.15, unit="K"),
    ]
    states = [
        state("T", 293.15, lb=288.15, ub=303.15, unit="K"),
        state("T_slack", 0.0, unit="K"),
    ]
    parameters = [
        parameter("cp", 1000.0),
        parameter("C", 100000.0),
        parameter("s_T", 1.0),
        parameter("r_mDot", 0.01),
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


class LinearRCZone(Model):
    """Linear 1R1C zone with DIRECT thermal-power actuation — the
    canonical *linear* MPC formulation of building control (the problem
    class the reference hands to its QP solvers qpoases/osqp/proxqp,
    ``data_structures/casadi_utils.py:52-61``). Where :class:`OneRoom`
    actuates an air mass flow (bilinear ``mDot·(T_in − T)`` term ⇒ a
    genuine NLP), here the control is the cooling power ``Q`` itself:

        dT/dt = (load − Q) / C + (T_amb − T) / (R·C)

    — affine dynamics, quadratic objective, affine constraints: an LQ
    program end to end, which the JAX package's structure probe
    certifies and routes to the Mehrotra QP fast path (``ops/qp.py``).
    """

    inputs = [
        control_input("Q", 0.0, lb=0.0, ub=500.0, unit="W",
                      description="cooling power extracted from the zone"),
        control_input("load", 150.0, unit="W"),
        control_input("T_amb", 303.15, unit="K"),
        control_input("T_upper", 295.15, unit="K"),
    ]
    states = [
        state("T", 293.15, lb=288.15, ub=310.15, unit="K"),
        state("T_slack", 0.0, unit="K"),
    ]
    parameters = [
        parameter("C", 100000.0, description="thermal capacity J/K"),
        parameter("R", 0.05, description="envelope resistance K/W"),
        parameter("s_T", 1.0),
        parameter("r_Q", 1e-3),
    ]
    outputs = [output("T_out", unit="K")]

    def setup(self, v):
        eq = ModelEquations()
        eq.ode("T", (v.load - v.Q) / v.C + (v.T_amb - v.T) / (v.R * v.C))
        eq.alg("T_out", v.T)
        eq.constraint(0.0, v.T + v.T_slack, v.T_upper)
        eq.objective = (
            SubObjective(v.Q, weight=v.r_Q, name="energy")
            + SubObjective(v.T_slack ** 2, weight=v.s_T, name="temp_slack")
        )
        return eq


class AirHandlingUnit(Model):
    """Central air-handling unit serving four zones — the supplier half of
    the 4-room coordinated-ADMM benchmark (reference
    ``examples/4_Room_ADMM_Coordinator/models/rlt_model.py``): four air
    mass flows, one shared capacity constraint ``sum(mDot_i) <= mDot_max``,
    flow production cost. Each ``mDot_out_i`` couples to room ``i``'s
    requested flow via consensus-ADMM.
    """

    inputs = [
        control_input(f"mDot_{i}", 0.0225, lb=0.0, ub=0.05, unit="m^3/s",
                      description=f"air mass flow to zone {i}")
        for i in range(1, 5)
    ]
    parameters = [
        parameter("mDot_max", 0.075, unit="m^3/s",
                  description="total AHU capacity"),
        parameter("r_mDot", 1.0, description="flow production cost weight"),
    ]
    outputs = [output(f"mDot_out_{i}", 0.0225, unit="m^3/s")
               for i in range(1, 5)]

    def setup(self, v):
        eq = ModelEquations()
        total = v.mDot_1 + v.mDot_2 + v.mDot_3 + v.mDot_4
        for i in range(1, 5):
            eq.alg(f"mDot_out_{i}", getattr(v, f"mDot_{i}"))
        eq.constraint(0.0, total, v.mDot_max)
        eq.objective = SubObjective(total, weight=v.r_mDot,
                                    name="flow_costs")
        return eq


class ExchangeRoom(Model):
    """Zone for the exchange-ADMM benchmark (reference
    ``examples/exchange_admm/models/room_model.py``): the room optimizes
    its own air request ``mDot`` (actuated per-room) and mirrors it into
    the exchange variable ``mDot_out = mDot``; the exchange mean-zero
    condition across all zones + the supplier balances total consumption
    against supply.
    """

    inputs = [
        control_input("mDot", 0.0225, lb=0.0, ub=0.05, unit="m^3/s",
                      description="air mass flow into the zone"),
        control_input("load", 150.0, unit="W"),
        control_input("T_in", 290.15, unit="K"),
        control_input("T_upper", 294.15, unit="K"),
    ]
    states = [
        state("T", 293.15, lb=288.15, ub=303.15, unit="K"),
        state("T_slack", 0.0, unit="K"),
    ]
    parameters = [
        parameter("cp", 1000.0),
        parameter("C", 100000.0),
        parameter("s_T", 1.0),
    ]
    outputs = [
        output("T_out", unit="K"),
        output("mDot_out", 0.0225, unit="m^3/s",
               description="net flow (positive = consumption)"),
    ]

    def setup(self, v):
        eq = ModelEquations()
        eq.ode("T", v.cp * v.mDot / v.C * (v.T_in - v.T) + v.load / v.C)
        eq.alg("T_out", v.T)
        eq.alg("mDot_out", v.mDot)
        eq.constraint(0.0, v.T + v.T_slack, v.T_upper)
        eq.objective = SubObjective(v.T_slack ** 2, weight=v.s_T,
                                    name="temp_slack")
        return eq


class AirSupplier(Model):
    """Supplier half of the exchange-ADMM benchmark (reference
    ``examples/exchange_admm/models/rlt_model.py``): produces air flow at
    cost; its *negative* net flow ``mDot_net = -mDot`` enters the exchange
    coupling so that the exchange mean-zero condition enforces
    supply = total zone consumption.
    """

    inputs = [
        control_input("mDot", 0.05, lb=0.0, ub=0.2, unit="m^3/s",
                      description="total air mass flow produced"),
    ]
    parameters = [parameter("r_mDot", 1.0)]
    outputs = [output("mDot_net", -0.05, unit="m^3/s",
                      description="net flow (negative = supply)")]

    def setup(self, v):
        eq = ModelEquations()
        eq.alg("mDot_net", -v.mDot)
        eq.objective = SubObjective(v.mDot, weight=v.r_mDot,
                                    name="flow_costs")
        return eq


class SwitchedRoom(Model):
    """Single zone with an on/off chiller — the mixed-integer benchmark
    (reference ``examples/one_room_mpc/mixed_integer``: a binary cooling
    stage enters the energy balance; the MPC must schedule it). The binary
    control ``on`` is declared as an ordinary [0,1] input; the MINLP/CIA
    backends enforce integrality (``backends/minlp_backend.py``).
    """

    inputs = [
        control_input("on", 0.0, lb=0.0, ub=1.0,
                      description="chiller stage on/off (binary control)"),
        control_input("load", 180.0, unit="W", description="heat load"),
        control_input("T_upper", 295.15, unit="K",
                      description="soft upper comfort bound"),
    ]
    states = [
        state("T", 294.15, lb=288.15, ub=303.15, unit="K"),
        state("T_slack", 0.0, unit="K"),
    ]
    parameters = [
        parameter("C", 100000.0, unit="J/K"),
        parameter("Q_cool", 500.0, unit="W", description="chiller capacity"),
        parameter("s_T", 10.0, description="comfort slack weight"),
        parameter("r_on", 0.01, description="chiller run cost"),
    ]
    outputs = [output("T_out", unit="K")]

    def setup(self, v):
        eq = ModelEquations()
        eq.ode("T", (v.load - v.on * v.Q_cool) / v.C)
        eq.alg("T_out", v.T)
        eq.constraint(0.0, v.T + v.T_slack, v.T_upper)
        eq.objective = (
            SubObjective(v.on, weight=v.r_on, name="chiller_costs")
            + SubObjective(v.T_slack ** 2, weight=v.s_T, name="temp_slack")
        )
        return eq
