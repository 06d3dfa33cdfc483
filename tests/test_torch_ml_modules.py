"""The port's data-driven agents against the JAX package on the module path
and the fused fleet, on the CPU in float64 with the plain LDLᵀ.

- ``examples/three_zone_datadriven_admm.py``'s seven agents (three
  ``jax_admm_ml`` zones, the physical AHU, three simulated rooms) through
  ``LocalMAS`` for one control step, cut to 4 ADMM iterations (the
  example runs 10), with the same three surrogate JSONs in both packages:
  the same ADMM iterations and solve iterations, the zones' first moves
  within 1e-6 m³/s;
- an ``ann_trainer`` that learns a plant from a seeded excitation and
  broadcasts its document, an ``ml_simulator`` twin that hot-swaps it, and
  an MPC backend that takes the trained document: the trained weights, the
  twin's trajectory and the MPC's solve against the JAX package's.

``FusedFleet`` over ML configs is in ``tests/test_torch_ml_fused_fleet.py``.
"""

import numpy as np
import pytest
import torch

from agentlib_mpc_tpu.ml import serialized as jser
from agentlib_mpc_torch import reference_configs as rc
from agentlib_mpc_torch.ml import serialized as tser

from _torch_threads import one_torch_thread  # noqa: F401

F64 = torch.float64
MOVE_TOL = 1e-6
WEIGHT_TOL = 1e-6
T_TOL = 1e-6
U_TOL = 1e-6
PLAIN = {"kkt_method": "ldl"}
ZONE_ADMM_ITERATIONS = 4


def _jax_mas(configs):
    import agentlib_mpc_tpu.modules  # noqa: F401 - registers module types
    from agentlib_mpc_tpu.runtime.mas import LocalMAS

    mas = LocalMAS(configs, env={"rt": False})
    return mas


def _port_mas(configs):
    from agentlib_mpc_torch.runtime.mas import LocalMAS

    return LocalMAS(configs, env={"rt": False}, device="cpu", dtype=F64)


# -- the three-zone data-driven ADMM -----------------------------------------

def _zone_docs():
    """The example's three zone surrogates (seeds 0, 1, 2) trained by the
    port's trainer on the CPU at 10 epochs."""
    return [rc.train_zone_surrogate(rc.ZONES_LOADS[i], epochs=10, seed=i,
                                    device="cpu").to_json()
            for i in range(rc.ZONES_N)]


def _zone_outcome(mas):
    zones = [mas.agents[f"Zone_{i}"].get_module("admm") for i in (1, 2, 3)]
    ahu = mas.agents["AHU"].get_module("admm")
    moves = [float(np.asarray(z._iter_rows[-1]["couplings"]["mDot"])[0])
             for z in zones]
    its = {m.agent.id: [r["iteration"] for r in m._iter_rows]
           for m in (*zones, ahu)}
    solves = {m.agent.id: [(int(s["iterations"]), bool(s["success"]))
                           for s in m.backend.stats_history]
              for m in (*zones, ahu)}
    return moves, its, solves


@pytest.fixture(scope="module")
def three_zone_step():
    docs = _zone_docs()
    port_cfgs = rc.three_zone_datadriven_configs(
        docs, max_iterations=ZONE_ADMM_ITERATIONS, solver=PLAIN)
    from examples import three_zone_datadriven_admm as ex

    jax_cfgs = ex.agent_configs([jser.load_serialized_model(d)
                                 for d in docs],
                                max_iterations=ZONE_ADMM_ITERATIONS)
    for cfgs in (port_cfgs, jax_cfgs):
        for agent in cfgs:
            for module in agent["modules"]:
                backend = module.get("optimization_backend")
                if backend is not None:
                    backend["solver"] = {**backend["solver"], **PLAIN}
                    if agent["id"] == "AHU":
                        backend["solver"]["qp_fast_path"] = "on"
    jmas, pmas = _jax_mas(jax_cfgs), _port_mas(port_cfgs)
    jmas.run(until=rc.ML_DT)
    pmas.run(until=rc.ML_DT)
    return _zone_outcome(jmas), _zone_outcome(pmas), pmas


def test_three_zone_step_matches_jax(three_zone_step):
    (jmoves, jits, jsolves), (moves, its, solves), _ = three_zone_step
    assert its == jits
    assert all(len(v) == ZONE_ADMM_ITERATIONS for v in its.values())
    assert solves == jsolves
    assert all(ok for rows in solves.values() for _, ok in rows)
    np.testing.assert_allclose(moves, jmoves, rtol=0, atol=MOVE_TOL)


def test_three_zone_agents_run_the_ml_backend(three_zone_step):
    from agentlib_mpc_torch.backends.ml_backend import MLADMMBackend

    *_, pmas = three_zone_step
    for i in (1, 2, 3):
        backend = pmas.agents[f"Zone_{i}"].get_module("admm").backend
        assert isinstance(backend, MLADMMBackend)
        assert backend.ocp.n_w + backend.ocp.n_g == 34
        assert backend.trajectory_layout()["x"] == ["T"]


# -- trainer → broadcast → hot swap -------------------------------------------

DT = 300.0
C = 50000.0
LOAD = 150.0


def _plant_class(model_mod, vars_mod):
    v_ = vars_mod

    class LinearPlant(model_mod.Model):
        inputs = [v_.control_input("Q", 0.0, lb=0.0, ub=500.0)]
        states = [v_.state("T", 295.15, lb=280.0, ub=320.0)]
        parameters = [v_.parameter("C", C), v_.parameter("load", LOAD)]
        outputs = [v_.output("T_out")]

        def setup(self, v):
            eq = model_mod.ModelEquations()
            eq.ode("T", (v.load - v.Q) / v.C)
            eq.alg("T_out", v.T)
            return eq

    return LinearPlant


def _seed_ann(ser):
    """A deliberately poor first surrogate of the twin (to be swapped)."""
    return ser.SerializedANN(
        dt=DT, inputs={"Q": ser.Feature(name="Q", lag=1)},
        output={"T": ser.OutputFeature(name="T", output_type="difference",
                                       recursive=True)},
        weights=[np.zeros((2, 4)), np.zeros((4, 1))],
        biases=[np.zeros(4), np.zeros(1)], activations=["tanh", "linear"])


def _twin_class(ml_mod, vars_mod, ser):
    v_ = vars_mod

    class NarxPlant(ml_mod.MLModel):
        inputs = [v_.control_input("Q", 0.0, lb=0.0, ub=500.0)]
        states = [v_.state("T", 295.15, lb=280.0, ub=320.0)]
        dt = DT
        ml_model_sources = [_seed_ann(ser)]

    return NarxPlant


def _training_loop_configs(plant, twin):
    times = np.arange(0, 7200, DT)
    q = np.random.default_rng(3).uniform(0.0, 500.0, size=len(times))
    return [
        {"id": "Source", "modules": [
            {"module_id": "com", "type": "local_broadcast"},
            {"module_id": "excite", "type": "data_source", "t_sample": DT,
             "data": {"Q": dict(zip(times, q))}}]},
        {"id": "Plant", "modules": [
            {"module_id": "com", "type": "local_broadcast"},
            {"module_id": "room", "type": "simulator",
             "model": {"class": plant}, "t_sample": DT,
             "inputs": [{"name": "Q", "alias": "Q"}], "states": [],
             "outputs": [{"name": "T_out", "alias": "T"}]}]},
        {"id": "Trainer", "modules": [
            {"module_id": "com", "type": "local_broadcast"},
            {"module_id": "learn", "type": "ann_trainer", "step_size": DT,
             "retrain_delay": 3600, "layers": [8], "epochs": 40,
             "learning_rate": 3e-2, "batch_size": 8,
             "inputs": [{"name": "Q", "alias": "Q"}],
             "outputs": [{"name": "T", "alias": "T"}]}]},
        {"id": "Twin", "modules": [
            {"module_id": "com", "type": "local_broadcast"},
            {"module_id": "twin", "type": "ml_simulator",
             "model": {"class": twin}, "t_sample": DT,
             "inputs": [{"name": "Q", "alias": "Q"}],
             "states": [{"name": "T", "value": 295.15, "shared": False}],
             "outputs": []}]},
    ]


@pytest.fixture(scope="module")
def training_loops():
    from agentlib_mpc_tpu.models import ml_model as jml
    from agentlib_mpc_tpu.models import model as jmodel
    from agentlib_mpc_tpu.models import variables as jvars
    from agentlib_mpc_torch.models import ml_model as tml
    from agentlib_mpc_torch.models import model as tmodel
    from agentlib_mpc_torch.models import variables as tvars

    out = {}
    for key, mas_of, mods in (
            ("jax", _jax_mas, (jmodel, jvars, jml, jser)),
            ("torch", _port_mas, (tmodel, tvars, tml, tser))):
        model_mod, vars_mod, ml_mod, ser = mods
        mas = mas_of(_training_loop_configs(
            _plant_class(model_mod, vars_mod),
            _twin_class(ml_mod, vars_mod, ser)))
        mas.run(until=7200)
        out[key] = mas
    return out


def _twin(mas):
    return mas.agents["Twin"].get_module("twin")


def test_ann_trainer_broadcast_matches_jax(training_loops):
    jmas, pmas = training_loops["jax"], training_loops["torch"]
    jtr = jmas.agents["Trainer"].get_module("learn")
    ptr = pmas.agents["Trainer"].get_module("learn")
    assert ptr._retrains == jtr._retrains >= 1
    jdoc = _twin(jmas).model.serialized["T"]
    pdoc = _twin(pmas).model.serialized["T"]
    assert pdoc.trainer_config["type"] == "ann_trainer"
    assert pdoc.input_columns == jdoc.input_columns == ["Q", "T"]
    for a, b in zip(pdoc.weights + pdoc.biases, jdoc.weights + jdoc.biases):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                                   atol=WEIGHT_TOL)


def test_ml_simulator_twin_matches_jax(training_loops):
    jrows = _twin(training_loops["jax"])._rows
    prows = _twin(training_loops["torch"])._rows
    assert len(prows) == len(jrows) > 20
    for a, b in zip(prows, jrows):
        assert a["time"] == b["time"]
        assert abs(a["T"] - b["T"]) <= T_TOL, a["time"]
    # the swapped-in surrogate moves the twin; the seed one could not
    assert len({round(r["T"], 6) for r in prows}) > 1


def test_trained_document_hot_swaps_into_the_mpc(training_loops):
    """The trainer's document, hot-swapped into an MPC backend over the
    twin's model class in both packages: the same solve."""
    from agentlib_mpc_tpu.backends.backend import (
        VariableReference as JRef,
        create_backend as jcreate,
    )
    from agentlib_mpc_torch.backends.backend import (
        VariableReference as TRef,
        create_backend as tcreate,
    )

    doc = _twin(training_loops["torch"]).model.serialized["T"].to_json()
    backends = []
    for create, ref, twin, kw in (
            (jcreate, JRef, type(_twin(training_loops["jax"]).model), {}),
            (tcreate, TRef, type(_twin(training_loops["torch"]).model),
             {"device": "cpu", "dtype": F64})):
        backend = create({"type": "jax_ml", "model": {"class": twin},
                          "solver": {"max_iter": 60, **PLAIN}}, **kw)
        backend.setup_optimization(ref(states=["T"], controls=["Q"]),
                                   time_step=DT, prediction_horizon=6)
        ocp = backend.ocp
        backend.update_ml_models(doc)
        assert backend.ocp is ocp      # same lags: the layout is kept
        backends.append(backend)
    rj, rt = (b.solve(0.0, {"T": 296.0, "Q__ub": 500.0}) for b in backends)
    assert rt["stats"]["iterations"] == rj["stats"]["iterations"]
    assert rt["stats"]["success"] and rj["stats"]["success"]
    np.testing.assert_allclose(rt["u0"]["Q"], rj["u0"]["Q"], rtol=0,
                               atol=U_TOL)
