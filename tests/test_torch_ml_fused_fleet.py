"""``FusedFleet`` over ML configs against the JAX package's, on the CPU in
float64 with the plain LDLᵀ: ``tests/test_fused_ml.py``'s NARX rooms, 4
zones, each with its own LinReg surrogate on one shared cooling power;
two rounds with the shift between them, the same ADMM iterations,
controls and states within 1e-6, and each agent optimizing against its
own surrogate (split from ``tests/test_torch_ml_modules.py``).
"""

import numpy as np
import torch

from agentlib_mpc_tpu.ml import serialized as jser
from agentlib_mpc_torch.ml import serialized as tser

from _torch_threads import one_torch_thread  # noqa: F401

F64 = torch.float64
T_TOL = 1e-6
U_TOL = 1e-6
PLAIN = {"kkt_method": "ldl"}


DT = 300.0

def _linreg(ser, c):
    return ser.SerializedLinReg(
        dt=DT,
        inputs={"Q": ser.Feature(name="Q", lag=1),
                "load": ser.Feature(name="load", lag=1)},
        output={"T": ser.OutputFeature(name="T", lag=1,
                                       output_type="difference",
                                       recursive=True)},
        coef=[[-DT / c, DT / c, 0.0]], intercept=[0.0]).to_json()


def _narx_room(ml_mod, model_mod, obj_mod, vars_mod, ser):
    v_ = vars_mod

    class NarxRoom(ml_mod.MLModel):
        inputs = [v_.control_input("Q", 0.0, lb=0.0, ub=1000.0),
                  v_.control_input("load", 180.0)]
        states = [v_.state("T", 294.15, lb=285.15, ub=310.15)]
        parameters = [v_.parameter("r_Q", 1e-4), v_.parameter("T_ref",
                                                              293.15)]
        dt = DT

        def setup(self, v):
            eq = model_mod.ModelEquations()
            eq.objective = (obj_mod.SubObjective((v.T - v.T_ref) ** 2,
                                                 name="track")
                            + obj_mod.SubObjective(v.r_Q * v.Q,
                                                   name="energy"))
            return eq

    return NarxRoom


def _fleet_configs(room, ser):
    caps = (100000.0, 200000.0, 150000.0, 120000.0)
    temps = (297.15, 297.15, 296.65, 297.65)
    return [{"id": f"Z_{i}", "modules": [
        {"module_id": "admm", "type": "admm_local",
         "optimization_backend": {
             "type": "jax_admm_ml",
             "model": {"class": room,
                       "ml_model_sources": [_linreg(ser, caps[i])]},
             "solver": {"max_iter": 40, "tol": 1e-6, **PLAIN}},
         "time_step": DT, "prediction_horizon": 6,
         "max_iterations": 20, "penalty_factor": 1e-3,
         "states": [{"name": "T", "value": temps[i]}],
         "couplings": [{"name": "Q", "alias": "Q_shared"}]}]}
        for i in range(4)]


def test_fused_fleet_over_ml_configs_matches_jax():
    from agentlib_mpc_tpu.models import ml_model as jml
    from agentlib_mpc_tpu.models import model as jmodel
    from agentlib_mpc_tpu.models import objective as jobj
    from agentlib_mpc_tpu.models import variables as jvars
    from agentlib_mpc_tpu.parallel.config_bridge import FusedFleet as JFleet
    from agentlib_mpc_torch.models import ml_model as tml
    from agentlib_mpc_torch.models import model as tmodel
    from agentlib_mpc_torch.models import objective as tobj
    from agentlib_mpc_torch.models import variables as tvars
    from agentlib_mpc_torch.parallel.config_bridge import FusedFleet

    jfleet = JFleet.from_configs(_fleet_configs(
        _narx_room(jml, jmodel, jobj, jvars, jser), jser))
    fleet = FusedFleet.from_configs(_fleet_configs(
        _narx_room(tml, tmodel, tobj, tvars, tser), tser), device="cpu",
        dtype=F64)
    assert len(fleet.engine.groups) == len(jfleet.engine.groups) == 1
    for step in range(2):
        jout, out = jfleet.step(), fleet.step()
        for aid in jout:
            assert out[aid]["iterations"] == jout[aid]["iterations"]
            np.testing.assert_allclose(out[aid]["u"]["Q"],
                                       np.asarray(jout[aid]["u"]["Q"]),
                                       rtol=0, atol=U_TOL)
            np.testing.assert_allclose(out[aid]["x"],
                                       np.asarray(jout[aid]["x"]), rtol=0,
                                       atol=T_TOL)
        jfleet.advance()
        fleet.advance()
    # each agent optimized against its own surrogate: the stiffer rooms
    # cool less under the shared cooling power
    dT = {aid: out[aid]["x"][0, 0] - out[aid]["x"][-1, 0] for aid in out}
    assert dT["Z_0"] > dT["Z_1"]
    df = fleet.results("Z_1")
    assert ("variable", "T") in df.columns and ("variable", "Q") in df.columns
