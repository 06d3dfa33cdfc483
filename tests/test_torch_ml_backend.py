"""The port's NARX transcription and ML backends against the JAX package.

- ``transcribe_ml`` of ``SurrogateRoom`` (examples/ml_mpc_one_room.py, the
  port's copy in ``reference_configs``) and of a hybrid model with lagged
  inputs, a white-box ODE state and a declarative output: ``f``, ``g``,
  ``h``, their derivatives and the trajectories at a seeded ``w`` within
  1e-10, in the JAX package's flat layout (``u``, ``x``, ``z``);
- the example's closed loop on ``jax_ml`` at 1 500 s (5 steps) with one
  surrogate JSON in both packages: temperatures within 1e-6 K and the same
  interior-point iterations;
- the hot swap with the same lags (the transcription kept) and with
  changed lags (re-transcribed), each solve against the JAX package's;
- ``jax_admm_ml``'s coupling trajectory against the JAX package's.

One surrogate is trained per file (the port's trainer on the CPU, 10
epochs) and its JSON used by both packages; both run f64 with the plain
LDLᵀ (``kkt_method="ldl"``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agentlib_mpc_tpu.backends.admm_backend import (
    ADMMVariableReference as JADMMRef,
)
from agentlib_mpc_tpu.backends.backend import (
    VariableReference as JRef,
    create_backend as jcreate,
)
from agentlib_mpc_tpu.ml import serialized as jser
from agentlib_mpc_tpu.models import ml_model as jml
from agentlib_mpc_tpu.models import model as jmodel
from agentlib_mpc_tpu.models import objective as jobj
from agentlib_mpc_tpu.models import variables as jvars
from agentlib_mpc_tpu.ops.ml_transcription import transcribe_ml as jtranscribe
from agentlib_mpc_torch import reference_configs as rc
from agentlib_mpc_torch.backends.admm_backend import (
    ADMMVariableReference as TADMMRef,
)
from agentlib_mpc_torch.backends.backend import (
    VariableReference as TRef,
    create_backend as tcreate,
)
from agentlib_mpc_torch.ml import Feature, OutputFeature
from agentlib_mpc_torch.ml import serialized as tser
from agentlib_mpc_torch.ml.training import (
    ANNTrainerCore,
    create_lagged_features,
    fit_ann,
    resample,
    train_val_test_split,
)
from agentlib_mpc_torch.models import ml_model as tml
from agentlib_mpc_torch.models import model as tmodel
from agentlib_mpc_torch.models import objective as tobj
from agentlib_mpc_torch.models import variables as tvars
from agentlib_mpc_torch.ops.ml_transcription import transcribe_ml as ttranscribe

from _torch_threads import one_torch_thread  # noqa: F401

DT = rc.ML_DT
FN_TOL = 1e-10
LOOP_T_TOL_K = 1e-6
U_TOL = 1e-6
SOLVER = {"max_iter": 60, "kkt_method": "ldl"}
ROLES = dict(states=["T"], controls=["Q"], inputs=["T_upper"],
             parameters=["s_T", "r_Q"])


def _train(lag_q=1, epochs=10):
    """The example's pipeline (500 seeded plant steps), with few epochs
    at a larger learning rate; ``lag_q`` deepens the heat flow's lag."""
    inputs = {"Q": Feature(name="Q", lag=lag_q)}
    output = {"T": OutputFeature(name="T", output_type="difference",
                                 recursive=True)}
    X, y = create_lagged_features(
        resample(rc.ml_room_training_data(), DT, method="previous"),
        inputs, output)
    data = train_val_test_split(X, y, (0.7, 0.15, 0.15), seed=0)
    return fit_ann(data.training_inputs, data.training_outputs,
                   data.validation_inputs, data.validation_outputs,
                   dt=DT, inputs=inputs, output=output,
                   trainer=ANNTrainerCore(hidden=(16, 16), epochs=epochs,
                                          learning_rate=3e-2,
                                          device="cpu")).to_json()


@pytest.fixture(scope="module")
def surrogate():
    return _train()


def _jax_room(doc):
    from examples.ml_mpc_one_room import SurrogateRoom

    return SurrogateRoom(ml_models=[jser.load_serialized_model(doc)])


def _backends(doc, horizon=10):
    jb = jcreate({"type": "jax_ml", "model": _jax_room(doc),
                  "solver": dict(SOLVER)})
    jb.setup_optimization(JRef(**ROLES), time_step=DT,
                          prediction_horizon=horizon)
    tb = tcreate(rc.ml_mpc_backend_config(doc, {"kkt_method": "ldl"}),
                 device="cpu", dtype=torch.float64)
    tb.setup_optimization(TRef(**ROLES), time_step=DT,
                          prediction_horizon=horizon)
    return jb, tb


def _solve_both(jb, tb, now, variables):
    rj, rt = jb.solve(now, variables), tb.solve(now, variables)
    assert rt["stats"]["iterations"] == rj["stats"]["iterations"], now
    assert rt["stats"]["success"] == rj["stats"]["success"], now
    np.testing.assert_allclose(rt["u0"]["Q"], rj["u0"]["Q"], rtol=0,
                               atol=U_TOL)
    return rj, rt


def _compare_nlp(jo, to, w, jtheta, ttheta):
    """f, g, h, their Jacobians, the Hessian of f and the trajectories at
    ``w`` (the JAX side as one jitted function)."""
    names = ("f", "g", "h")

    def jax_side(ww, th):
        return ([getattr(jo.nlp, n)(ww, th) for n in names],
                [jax.jacrev(getattr(jo.nlp, n))(ww, th) for n in names],
                jax.hessian(jo.nlp.f)(ww, th), jo.trajectories(ww, th))

    vals, jacs, hess, traj = jax.jit(jax_side)(jnp.asarray(w), jtheta)
    wt = torch.as_tensor(w)
    for n, val, jac in zip(names, vals, jacs):
        fn = getattr(to.nlp, n)
        np.testing.assert_allclose(fn(wt, ttheta).numpy(), np.asarray(val),
                                   rtol=FN_TOL, atol=FN_TOL, err_msg=n)
        np.testing.assert_allclose(
            torch.func.jacrev(fn)(wt, ttheta).numpy(), np.asarray(jac),
            rtol=FN_TOL, atol=FN_TOL, err_msg=f"d{n}/dw")
    np.testing.assert_allclose(
        torch.func.hessian(to.nlp.f)(wt, ttheta).numpy(), np.asarray(hess),
        rtol=FN_TOL, atol=FN_TOL, err_msg="d2f/dw2")
    tt = to.trajectories(wt, ttheta)
    assert set(traj) == set(tt)
    for key in traj:
        np.testing.assert_allclose(tt[key].numpy(), np.asarray(traj[key]),
                                   rtol=FN_TOL, atol=FN_TOL, err_msg=key)


def test_surrogate_room_transcription_matches_jax(surrogate):
    jo = jtranscribe(_jax_room(surrogate), ["Q"], N=10, dt=DT)
    to = ttranscribe(rc.SurrogateRoom(ml_models=[surrogate]), ["Q"], N=10,
                     dt=DT)
    assert (to.n_w, to.n_g, to.n_h) == (jo.n_w, jo.n_g, jo.n_h) == \
        (31, 11, 20)
    assert (to.dyn_names, to.slack_names, to.exo_names) == \
        (jo.dyn_names, jo.slack_names, jo.exo_names)
    rng = np.random.default_rng(0)
    parts = {"u": rng.uniform(0.0, 1000.0, (10, 1)),
             "x": 296.0 + rng.normal(size=(11, 1)),
             "z": rng.normal(size=(10, 1))}
    w = np.array(jo.flatten(parts))
    for key, part in to.unflatten(torch.as_tensor(w)).items():
        np.testing.assert_array_equal(part.numpy(), parts[key])
    jtheta = jo.default_params(x0=jnp.array([297.3]),
                               t0=jnp.asarray(600.0))
    ttheta = to.default_params(device="cpu", dtype=torch.float64,
                               x0=[297.3], t0=600.0)
    _compare_nlp(jo, to, w, jtheta, ttheta)
    lb_j, ub_j = jo.bounds(jtheta)
    lb_t, ub_t = to.bounds(ttheta)
    np.testing.assert_array_equal(lb_t.numpy(), np.asarray(lb_j))
    np.testing.assert_array_equal(ub_t.numpy(), np.asarray(ub_j))
    np.testing.assert_array_equal(to.initial_guess(ttheta).numpy(),
                                  np.asarray(jo.initial_guess(jtheta)))
    np.testing.assert_array_equal(
        to.shift_guess(torch.as_tensor(w), ttheta).numpy(),
        np.asarray(jo.shift_guess(jnp.asarray(w), jtheta)))


def _hybrid_surrogate(ser):
    """T learned with a lag-2 heat flow, a lag-1 disturbance and its own
    lag 3 (a seeded ANN); the wall temperature stays white-box."""
    rng = np.random.default_rng(11)
    return ser.SerializedANN(
        dt=DT,
        inputs={"Q": ser.Feature(name="Q", lag=2),
                "d": ser.Feature(name="d", lag=1),
                "Tw": ser.Feature(name="Tw", lag=1)},
        output={"T": ser.OutputFeature(name="T", lag=3,
                                       output_type="difference")},
        weights=[rng.normal(size=(7, 5)) * 0.01, rng.normal(size=(5, 1))],
        biases=[rng.normal(size=5) * 0.1, rng.normal(size=1) * 0.01],
        activations=["tanh", "linear"])


def _hybrid_class(mod_ml, mod_model, mod_obj, mod_vars, ser):
    """One hybrid NARX model declared against either package."""
    v_ = mod_vars

    class Hybrid(mod_ml.MLModel):
        inputs = [v_.control_input("Q", 100.0, lb=0.0, ub=1000.0),
                  v_.control_input("d", 20.0)]
        states = [v_.state("T", 296.0, lb=285.0, ub=310.0),
                  v_.state("Tw", 295.0), v_.state("s", 0.0)]
        parameters = [v_.parameter("tau", 3600.0)]
        outputs = [v_.output("P", 0.0)]
        dt = DT
        ml_model_sources = [_hybrid_surrogate(ser)]

        def setup(self, v):
            eq = mod_model.ModelEquations()
            eq.ode("Tw", (v.T - v.Tw) / v.tau)
            eq.alg("P", 2.0 * v.Q + v.Tw)
            eq.constraint(0.0, v.T + v.s, 297.0)
            eq.objective = (mod_obj.SubObjective(v.Q, weight=1e-3,
                                                 name="energy")
                            + mod_obj.SubObjective(v.s ** 2, name="comfort"))
            return eq

    return Hybrid


def test_lagged_hybrid_transcription_matches_jax():
    jm = _hybrid_class(jml, jmodel, jobj, jvars, jser)()
    tm = _hybrid_class(tml, tmodel, tobj, tvars, tser)()
    assert tm.history_names == jm.history_names
    assert tm.get_lags_per_variable() == jm.get_lags_per_variable() == \
        {"Q": 2, "T": 3}
    jo = jtranscribe(jm, ["Q"], N=6, dt=DT)
    to = ttranscribe(tm, ["Q"], N=6, dt=DT)
    assert (to.n_w, to.n_g, to.n_h, to.dyn_names) == \
        (jo.n_w, jo.n_g, jo.n_h, jo.dyn_names)
    rng = np.random.default_rng(1)
    w = np.array(jo.flatten({
        "u": rng.uniform(0.0, 500.0, (6, 1)),
        "x": 295.0 + rng.normal(size=(7, 2)),
        "z": rng.normal(size=(6, 1))}))
    past = {"Q": [150.0], "T": [296.4, 296.9], "Tw": [], "d": []}
    d_traj = 20.0 + rng.normal(size=(6, 1))
    jtheta = jo.default_params(
        x0=jnp.array([296.1, 295.2]), d_traj=jnp.asarray(d_traj),
        past={k: jnp.asarray(v) for k, v in past.items()},
        t0=jnp.asarray(900.0))
    ttheta = to.default_params(device="cpu", dtype=torch.float64,
                               x0=[296.1, 295.2], d_traj=d_traj,
                               past=past, t0=900.0)
    _compare_nlp(jo, to, w, jtheta, ttheta)


@pytest.fixture(scope="module")
def closed_loop(surrogate):
    """The example's loop for 1 500 s in both packages; the hot-swap tests
    below go on with the same two backends."""
    jb, tb = _backends(surrogate)
    Tj = Tt = 297.5
    rows = []
    for k in range(5):
        rj, rt = jb.solve(k * DT, {"T": Tj}), tb.solve(k * DT, {"T": Tt})
        Tj = rc.ml_room_plant_step(Tj, rj["u0"]["Q"])
        Tt = rc.ml_room_plant_step(Tt, rt["u0"]["Q"])
        rows.append((Tj, Tt, rj["stats"], rt["stats"]))
    return jb, tb, rows


def test_ml_mpc_closed_loop_matches_jax(closed_loop):
    _, _, rows = closed_loop
    for Tj, Tt, sj, st in rows:
        assert st["success"] and sj["success"]
        assert st["iterations"] == sj["iterations"]
        assert abs(Tt - Tj) <= LOOP_T_TOL_K
    assert all(Tt < 297.5 for _, Tt, _, _ in rows)


def test_trajectory_layout_and_lags(closed_loop):
    jb, tb, _ = closed_loop
    assert tb.trajectory_layout() == jb.trajectory_layout() == {
        "x": ["T"], "u": ["Q"], "y": [], "z": ["T_slack"]}
    assert tb.get_lags_per_variable() == jb.get_lags_per_variable() == {}


def test_ml_params_from_jax_load_into_the_port(closed_loop):
    """A JAX model's trained weights (``ml_params``) into the port's
    backend through ``utils.convert``: the next solve as the JAX
    package's."""
    from agentlib_mpc_torch.utils.convert import (
        load_ml_model_state,
        ml_params_from_jax,
    )

    jb, tb, rows = closed_loop
    jb.update_ml_models(_train(epochs=3))
    params = ml_params_from_jax(jb.model, device="cpu")
    assert params["T"]["W"][0].dtype == torch.float64
    load_ml_model_state(tb, jb.model)
    T = rows[-1][0]
    _solve_both(jb, tb, 5 * DT, {"T": T})
    with pytest.raises(KeyError, match="surrogates"):
        load_ml_model_state(tb, {"other": params["T"]})


def test_hot_swap_keeps_the_transcription_for_the_same_lags(closed_loop):
    jb, tb, _ = closed_loop
    ocp, step = tb.ocp, tb._step
    retrained = _train(epochs=4)
    jb.update_ml_models(retrained)
    tb.update_ml_models(retrained)
    assert tb.ocp is ocp and tb._step is step
    _solve_both(jb, tb, 6 * DT, {"T": 297.2})


def test_hot_swap_with_changed_lags_retranscribes(closed_loop):
    jb, tb, _ = closed_loop
    _solve_both(jb, tb, 7 * DT, {"T": 297.5})
    ocp = tb.ocp
    lagged = _train(lag_q=2, epochs=3)
    jb.update_ml_models(lagged)
    tb.update_ml_models(lagged)
    assert tb.ocp is not ocp
    assert tb.get_lags_per_variable() == jb.get_lags_per_variable() == \
        {"Q": 2}
    _solve_both(jb, tb, 8 * DT, {"T": 297.2,
                                 "Q": ([7 * DT, 8 * DT], [400.0, 400.0])})


def test_admm_ml_coupling_trajectory_matches_jax(surrogate):
    roles = dict(states=["T"], controls=[], inputs=["T_upper"],
                 parameters=["s_T", "r_Q"], couplings=["Q"])
    jb = jcreate({"type": "jax_admm_ml", "model": _jax_room(surrogate),
                  "solver": dict(SOLVER)})
    jb.setup_optimization(JADMMRef(**roles), time_step=DT,
                          prediction_horizon=6)
    tb = tcreate({**rc.ml_mpc_backend_config(surrogate, {"kkt_method":
                                                         "ldl"}),
                  "type": "jax_admm_ml"}, device="cpu", dtype=torch.float64)
    tb.setup_optimization(TADMMRef(**roles), time_step=DT,
                          prediction_horizon=6)
    variables = {"T": 297.15, "admm_coupling_mean_Q": 300.0,
                 "admm_lambda_Q": 0.5, "penalty_factor": 1e-4}
    rj, rt = jb.solve(0.0, variables), tb.solve(0.0, variables)
    assert rt["stats"]["iterations"] == rj["stats"]["iterations"]
    assert rt["stats"]["success"] and rj["stats"]["success"]
    assert rt["u0"] == {} and rj["u0"] == {}
    np.testing.assert_allclose(rt["couplings"]["Q"],
                               np.asarray(rj["couplings"]["Q"]), rtol=0,
                               atol=U_TOL)


def test_dt_mismatch_rejected(surrogate):
    tb = tcreate(rc.ml_mpc_backend_config(surrogate), device="cpu",
                 dtype=torch.float64)
    with pytest.raises(ValueError, match="dt"):
        tb.setup_optimization(TRef(states=["T"], controls=["Q"]),
                              time_step=60.0, prediction_horizon=4)
