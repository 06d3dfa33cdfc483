"""The port's FusedFleet against the JAX package's, on the CPU in float64.

Four rooms of ``examples/fused_fleet_rooms.py`` (``chip_smoke.
room_config``, the example's config with the model named by its zoo
name, so the same dicts build both packages' fleets; the solver config
adds ``kkt_method="ldl"``, the plain LDLᵀ versions in both) go through
``FusedFleet.from_configs`` of both packages: a cold round, plant feedback
by ``update_agent``, ``advance`` and a warm round; per-agent controls and
states within 1e-8 relative (same algorithms in float64), equal iteration
counts and convergence flags, equal ``admm_results``, ``iteration_stats``
and ``results`` frames. Then the port's checkpoint round trip (its own
format, ``utils/checkpoint.py``): a fleet restored into a fresh build
continues bit for bit. And every error the bridge raises.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from agentlib_mpc_tpu.parallel.config_bridge import FusedFleet as JFleet
from agentlib_mpc_torch.models.zoo import CooledRoom
from agentlib_mpc_torch.parallel.config_bridge import FusedFleet
from agentlib_mpc_torch.parallel.fused_admm import FusedADMMOptions

from _torch_threads import one_torch_thread  # noqa: F401

F64 = torch.float64
RTOL = 1e-8
N_ROOMS = 4


def configs(n=N_ROOMS):
    loads = np.linspace(80.0, 220.0, n)
    out = []
    for i in range(n):
        cfg = chip_smoke.room_config(i, float(loads[i]))
        cfg["modules"][1]["optimization_backend"]["solver"]["kkt_method"] = \
            "ldl"
        out.append(cfg)
    return out


def port_fleet(cfgs, **kw):
    return FusedFleet.from_configs(cfgs, device="cpu", dtype=F64, **kw)


def test_room_config_is_the_examples():
    """chip_smoke's room config is the example's, with the model class
    named by its zoo name."""
    import examples.fused_fleet_rooms as ex

    ours = chip_smoke.room_config(3, 123.0)
    theirs = ex.room_config(3, 123.0)
    backend = theirs["modules"][1]["optimization_backend"]
    assert backend["model"]["class"].__name__ == "CooledRoom"
    backend["model"]["class"] = "CooledRoom"
    assert ours == theirs
    assert (chip_smoke.FLEET_DT, chip_smoke.FLEET_HORIZON,
            chip_smoke.FLEET_MAX_ITERATIONS, chip_smoke.FLEET_UB,
            chip_smoke.FLEET_T_IN, chip_smoke.FLEET_START) == \
        (ex.TIME_STEP, ex.HORIZON, ex.MAX_ITERATIONS, ex.UB, ex.T_IN,
         ex.START_TEMP)


def close(port, ref, what):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(port), ref, rtol=RTOL,
                               atol=RTOL * max(np.abs(ref).max(), 1e-30),
                               err_msg=what)


def assert_outputs_equal(out, jout):
    assert set(out) == set(jout)
    for aid, res in jout.items():
        assert out[aid]["iterations"] == res["iterations"]
        assert out[aid]["converged"] == res["converged"]
        for name, u in res["u"].items():
            close(out[aid]["u"][name], u, f"{aid} u {name}")
        close(out[aid]["x"], res["x"], f"{aid} x")


@pytest.fixture(scope="module")
def both_fleets():
    """Two control intervals through both packages with the same plant
    feedback (the JAX round's first controls on the port's plant)."""
    cfgs = configs()
    jfleet = JFleet.from_configs(copy.deepcopy(cfgs))
    fleet = port_fleet(copy.deepcopy(cfgs))
    outs = [(jfleet.step(), fleet.step())]
    plant = CooledRoom()
    p = plant.default_vector("parameters", device="cpu", dtype=F64)
    loads = np.linspace(80.0, 220.0, N_ROOMS)
    for i in range(N_ROOMS):
        aid = f"Room_{i}"
        u = torch.tensor([float(outs[0][0][aid]["u"]["mDot"][0]), loads[i],
                          chip_smoke.FLEET_T_IN, chip_smoke.FLEET_UB],
                         dtype=F64)
        x_next, _ = plant.simulate_step(
            torch.tensor([chip_smoke.FLEET_START], dtype=F64), u, p,
            chip_smoke.FLEET_DT)
        jfleet.update_agent(aid, x0=[float(x_next[0])])
        fleet.update_agent(aid, x0=[float(x_next[0])])
    jfleet.advance()
    fleet.advance()
    outs.append((jfleet.step(), fleet.step()))
    return jfleet, fleet, outs


@pytest.mark.parametrize("which", [0, 1], ids=["cold", "warm"])
def test_fleet_rounds_match_jax(both_fleets, which):
    jout, out = both_fleets[2][which]
    assert_outputs_equal(out, jout)


def test_fleet_structure_matches_jax(both_fleets):
    jfleet, fleet, _ = both_fleets
    assert len(fleet.engine.groups) == len(jfleet.engine.groups) == 1
    assert fleet.engine.group_uses_qp == jfleet.engine.group_uses_qp
    assert fleet.N == jfleet.N and fleet.dt == jfleet.dt
    assert fleet.time == jfleet.time == chip_smoke.FLEET_DT
    assert fleet.engine.options._replace(rho=0) == \
        jfleet.engine.options._replace(rho=0)
    assert fleet.engine.options.rho == jfleet.engine.options.rho


def test_admm_results_match_jax(both_fleets):
    jfleet, fleet, _ = both_fleets
    for aid in ("Room_0", "Room_3"):
        a, b = fleet.admm_results(aid), jfleet.admm_results(aid)
        assert list(a.index) == list(b.index)
        assert list(a.columns) == list(b.columns)
        close(a.to_numpy(), b.to_numpy(), f"admm_results {aid}")
    assert fleet.admm_results("nobody") is None


def test_iteration_stats_and_results_match_jax(both_fleets):
    jfleet, fleet, _ = both_fleets
    a, b = fleet.iteration_stats(), jfleet.iteration_stats()
    assert list(a.index) == list(b.index)
    close(a.to_numpy(), b.to_numpy(), "iteration_stats")
    a, b = fleet.results("Room_2"), jfleet.results("Room_2")
    assert list(a.columns) == list(b.columns)
    np.testing.assert_allclose(a.to_numpy(), b.to_numpy(), rtol=RTOL,
                               atol=RTOL * np.nanmax(np.abs(b.to_numpy())))
    assert fleet.last_stats is not None


def test_checkpoint_round_trip(tmp_path):
    cfgs = configs(3)
    fleet = port_fleet(cfgs)
    fleet.step()
    fleet.update_agent("Room_1", x0=[297.0])
    fleet.advance()
    path = fleet.save_checkpoint(str(tmp_path / "ckpt"))
    out_continued = fleet.step()
    resumed = port_fleet(cfgs)
    resumed.restore_checkpoint(path)
    assert resumed.time == fleet.dt
    out_resumed = resumed.step()
    for aid, res in out_continued.items():
        np.testing.assert_array_equal(out_resumed[aid]["u"]["mDot"],
                                      res["u"]["mDot"])
        np.testing.assert_array_equal(out_resumed[aid]["x"], res["x"])
    # a fleet of another size cannot take it
    with pytest.raises(ValueError, match="not compatible"):
        port_fleet(configs(4)).restore_checkpoint(path)


def test_cleanup_and_record_off():
    fleet = port_fleet(configs(2), options=FusedADMMOptions(
        max_iterations=2, rho=20.0))
    fleet.step()
    assert fleet.results("Room_0") is not None
    fleet.cleanup_results()
    assert fleet.results("Room_0") is None
    assert fleet.iteration_stats() is None
    assert fleet.engine.options.max_iterations == 2


def test_bridge_errors():
    cfg = configs(1)[0]
    out_cpl = copy.deepcopy(cfg)
    out_cpl["modules"][1]["couplings"] = [{"name": "T_out", "alias": "x"}]
    with pytest.raises(NotImplementedError, match="module path"):
        port_fleet([out_cpl])
    other = copy.deepcopy(cfg)
    other["id"] = "Room_9"
    other["modules"][1]["prediction_horizon"] = 9
    with pytest.raises(ValueError, match="horizon"):
        port_fleet([cfg, other])
    other = copy.deepcopy(cfg)
    other["modules"][1]["time_step"] = 600.0
    with pytest.raises(ValueError, match="time_step"):
        port_fleet([cfg, other])
    other = copy.deepcopy(cfg)
    other["modules"][1]["penalty_factor"] = 50.0
    with pytest.raises(ValueError, match="penalty_factor"):
        port_fleet([cfg, other])
    sim = {"id": "Sim", "modules": [{"module_id": "sim",
                                     "type": "simulator"}]}
    with pytest.raises(ValueError, match="no ADMM"):
        port_fleet([sim])
    ml = copy.deepcopy(cfg)
    ml["modules"][1]["optimization_backend"]["model"][
        "ml_model_sources"] = ["m.json"]
    # an ML config loads through the ML loader, which wants an MLModel
    with pytest.raises(TypeError, match="MLModel"):
        port_fleet([ml])
    fleet = port_fleet([cfg, sim])          # the simulator is skipped
    assert [a.agent_id for a in fleet._agents] == ["Room_0"]
    with pytest.raises(KeyError, match="exogenous"):
        fleet.update_agent("Room_0", inputs={"Load": 250.0})


def test_partial_bounds_and_feedback():
    cfg = configs(1)[0]
    mod = cfg["modules"][1]
    mod["controls"] = [{"name": "mDot", "ub": 0.03}]
    mod["couplings"] = [{"name": "mDot", "alias": "mDotShared", "lb": 0.01}]
    fleet = port_fleet([cfg])
    theta = fleet._agents[0].theta(fleet.N, "cpu", F64)
    assert float(theta.u_lb.max()) == pytest.approx(0.01)
    assert float(theta.u_ub.min()) == pytest.approx(0.03)
    fleet.update_agent("Room_0", x0=[296.5], inputs={"load": 99.0},
                       parameters={"s_T": 2.0})
    batch = fleet._theta_batches[0]
    assert float(batch.x0[0, 0]) == 296.5
    assert float(batch.d_traj[0, 0, 0]) == 99.0
    assert float(batch.p[0, 2]) == 2.0


def test_exchange_configs_balance_to_zero():
    """'exchange' entries ride the bridge too: trackers exchanging their
    control settle at u_i = a_i − mean(a)."""
    from agentlib_mpc_torch.models.model import Model, ModelEquations
    from agentlib_mpc_torch.models.objective import SubObjective
    from agentlib_mpc_torch.models.variables import control_input, parameter

    class Tracker(Model):
        inputs = [control_input("u", 0.0, lb=-10.0, ub=10.0)]
        parameters = [parameter("a", 1.0)]

        def setup(self, v):
            eq = ModelEquations()
            eq.objective = SubObjective((v.u - v.a) ** 2, name="track")
            return eq

    def cfg(i, a):
        return {"id": f"T_{i}", "modules": [
            {"module_id": "admm", "type": "admm_local",
             "optimization_backend": {
                 "model": {"class": Tracker},
                 "discretization_options": {"method": "multiple_shooting"},
                 "solver": {"max_iter": 40, "tol": 1e-8}},
             "time_step": 300.0, "prediction_horizon": 4,
             "max_iterations": 50, "penalty_factor": 1.0,
             "parameters": [{"name": "a", "value": a}],
             "exchange": [{"name": "u", "alias": "power"}]}]}

    targets = (2.0, -1.0, 5.0)
    fleet = port_fleet([cfg(i, a) for i, a in enumerate(targets)],
                       options=FusedADMMOptions(max_iterations=50, rho=1.0,
                                                abs_tol=1e-6, rel_tol=1e-5))
    out = fleet.step()
    u = np.stack([out[f"T_{i}"]["u"]["u"] for i in range(3)])
    np.testing.assert_allclose(u.sum(axis=0), 0.0, atol=5e-3)
    for i, a in enumerate(targets):
        np.testing.assert_allclose(u[i], a - np.mean(targets), atol=5e-3)


def test_fleet_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        FusedFleet.from_configs(configs(1))


def test_jax_side_still_takes_the_string_class():
    """The JAX package builds the same string-named config (the parity
    fixture's premise)."""
    fleet = JFleet.from_configs(configs(1))
    assert type(fleet._agents[0].model).__name__ == "CooledRoom"
    assert fleet._agents[0].theta(fleet.N).x0.shape == (1,)
    assert jnp.asarray(fleet._agents[0].x0).shape == (1,)
