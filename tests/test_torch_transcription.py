"""The port's model and transcriptions against the JAX package.

Everything in float64 on the CPU: same inputs (made with numpy from a
seed), values compared to 1e-12 relative (round-off of a different
summation order), Jacobians from ``torch.func.jacrev`` against
``jax.jacrev``. The transcriptions under test are the benchmark's zone OCP
(``bench.zone_ocp``: ZoneWithSupply, degree-2 Radau collocation, N=10) and
the same zone by multiple shooting (N=4, dt=900 s, 3 integrator steps per
interval).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacrev

import bench
from agentlib_mpc_tpu.models import zoo as jzoo
from agentlib_mpc_torch.models import zoo
from agentlib_mpc_torch.parallel.admm_step import zone_ocp
from agentlib_mpc_torch.utils.convert import ocp_params_from_numpy, to_numpy

from _torch_threads import one_torch_thread  # noqa: F401

F64 = torch.float64


def _close(a, b, rtol=1e-12):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    np.testing.assert_allclose(a, b, rtol=rtol,
                               atol=rtol * max(1.0, float(np.abs(b).max(
                                   initial=0.0))))


@pytest.fixture(scope="module")
def ocps():
    return bench.zone_ocp(), zone_ocp()


@pytest.fixture(scope="module")
def point(ocps):
    """A random decision vector and per-zone parameters, in both forms."""
    jocp, _ = ocps
    rng = np.random.default_rng(7)
    theta_j = jocp.default_params(
        x0=jnp.asarray([rng.uniform(294.0, 300.0)]),
        d_traj=jnp.stack([jnp.asarray(rng.uniform(80, 250, size=10)),
                          jnp.full(10, 290.15), jnp.full(10, 294.15)], -1))
    theta_t = ocp_params_from_numpy(
        {k: np.asarray(v) for k, v in theta_j._asdict().items()}, "cpu", F64)
    lb, ub = jocp.bounds(theta_j)
    w = np.asarray(lb) + rng.uniform(0.1, 0.9, size=jocp.n_w) * np.minimum(
        np.asarray(ub) - np.asarray(lb), 20.0)
    return w, theta_j, theta_t


@pytest.mark.parametrize("model_name", ["ZoneWithSupply", "OneRoom",
                                        "LinearRCZone"])
def test_model_functions_match_at_random_points(model_name):
    jm, tm = getattr(jzoo, model_name)(), getattr(zoo, model_name)()
    assert tm.diff_state_names == jm.diff_state_names
    assert tm.free_state_names == jm.free_state_names
    assert tm.objective_term_names == jm.objective_term_names
    rng = np.random.default_rng(3)
    for _ in range(5):
        x = rng.uniform(290, 300, size=jm.n_diff)
        z = rng.uniform(-1, 1, size=jm.n_free)
        u = np.asarray(jm.default_vector("inputs")) * rng.uniform(
            0.5, 1.5, size=len(jm.input_names))
        p = np.asarray(jm.default_vector("parameters")) * rng.uniform(
            0.5, 1.5, size=len(jm.parameter_names))
        du = rng.normal(size=len(jm.input_names))
        ja = [jnp.asarray(a) for a in (x, z, u, p)]
        ta = [torch.as_tensor(a, dtype=F64) for a in (x, z, u, p)]
        _close(tm.ode(*ta), jm.ode(*ja))
        _close(tm.output(*ta), jm.output(*ja))
        _close(tm.constraint_residuals(*ta), jm.constraint_residuals(*ja))
        _close(tm.stage_cost(*ta, du=torch.as_tensor(du)),
               jm.stage_cost(*ja, du=jnp.asarray(du)))
        jt = jm.stage_cost_terms(*ja)
        tt = tm.stage_cost_terms(*ta)
        assert list(tt) == list(jt)
        for k in jt:
            _close(tt[k], jt[k])


def _objective_zoo_model(pkg):
    """One model with every objective term, built from either package's
    model and objective modules (``pkg`` is the package's name)."""
    import importlib

    mm = importlib.import_module(f"{pkg}.models.model")
    ob = importlib.import_module(f"{pkg}.models.objective")
    va = importlib.import_module(f"{pkg}.models.variables")

    class Objectives(mm.Model):
        inputs = [va.control_input("q", 1.0, lb=0.0, ub=5.0),
                  va.control_input("d", 0.5)]
        states = [va.state("T", 293.0), va.state("e", 0.0)]
        parameters = [va.parameter("w", 2.0), va.parameter("T_ref", 294.0)]
        outputs = [va.output("dev"), va.output("dev2")]

        def setup(self, v):
            eq = mm.ModelEquations()
            eq.ode("T", v.d - 0.01 * v.q)
            eq.alg("dev", v.T - v.T_ref)
            eq.alg("dev2", v.dev * 2.0)    # output-to-output chain
            eq.constraint(-1.0, v.dev2 + v.e, float("inf"))
            eq.objective = ob.CombinedObjective(
                ob.SubObjective([v.q, v.e ** 2], weight=v.w, name="use"),
                ob.ChangePenaltyObjective(v.du("q"), weight=0.3),
                ob.ChangePenaltyObjective(v.du("d"), quadratic=False,
                                          name="abs_move"),
                ob.ConditionalObjective(v.dev > 0, v.dev ** 2, 0.1 * v.dev,
                                        name="band"),
                normalization=3.0) * 0.5
            return eq

    return Objectives()


def test_objective_terms_and_output_chains_match():
    jm = _objective_zoo_model("agentlib_mpc_tpu")
    tm = _objective_zoo_model("agentlib_mpc_torch")
    assert tm.objective_term_names == jm.objective_term_names
    rng = np.random.default_rng(5)
    for T in (292.0, 296.0):
        x, z = np.array([T]), np.array([0.3])
        u, p = np.array([1.5, 0.2]), np.array([2.0, 294.0])
        du = rng.normal(size=2)
        ja = [jnp.asarray(a) for a in (x, z, u, p)]
        ta = [torch.as_tensor(a, dtype=F64) for a in (x, z, u, p)]
        _close(tm.output(*ta), jm.output(*ja))
        _close(tm.constraint_residuals(*ta), jm.constraint_residuals(*ja))
        _close(tm.stage_cost(*ta, du=torch.as_tensor(du)),
               jm.stage_cost(*ja, du=jnp.asarray(du)))
        jt = jm.stage_cost_terms(*ja, du=jnp.asarray(du))
        tt = tm.stage_cost_terms(*ta, du=torch.as_tensor(du))
        assert list(tt) == list(jt)
        for k in jt:
            _close(tt[k], jt[k])


def test_zone_ocp_sizes_and_flat_layout(ocps):
    """n_w/n_g/n_h of the benchmark zone and the ravel_pytree key order
    u (10), x (11), xc (20), z (20)."""
    jocp, tocp = ocps
    assert (tocp.n_w, tocp.n_g, tocp.n_h) == (jocp.n_w, jocp.n_g,
                                              jocp.n_h) == (61, 31, 40)
    w = np.arange(61, dtype=np.float64)
    jparts = jocp.unflatten(jnp.asarray(w))
    tparts = tocp.unflatten(torch.as_tensor(w))
    assert list(tparts) == ["u", "x", "xc", "z"]
    for k in tparts:
        np.testing.assert_array_equal(tparts[k].numpy(),
                                      np.asarray(jparts[k]))
    assert [tparts[k].numel() for k in tparts] == [10, 11, 20, 20]
    np.testing.assert_array_equal(tocp.flatten(tparts).numpy(), w)
    # leading batch axes ride along
    batched = tocp.unflatten(torch.as_tensor(np.stack([w, -w])))
    assert batched["xc"].shape == (2, 10, 2, 1)
    np.testing.assert_array_equal(tocp.flatten(batched)[1].numpy(), -w)


@pytest.mark.parametrize("fn", ["f", "g", "h"])
def test_nlp_values_and_jacobians_match(ocps, point, fn):
    jocp, tocp = ocps
    w, theta_j, theta_t = point
    jf = getattr(jocp.nlp, fn)
    tf = getattr(tocp.nlp, fn)
    wt = torch.as_tensor(w, dtype=F64)
    _close(tf(wt, theta_t), jf(jnp.asarray(w), theta_j))
    _close(jacrev(tf)(wt, theta_t), jax.jacrev(jf)(jnp.asarray(w), theta_j))


def test_bounds_guess_shift_and_trajectories_match(ocps, point):
    jocp, tocp = ocps
    w, theta_j, theta_t = point
    for a, b in zip(tocp.bounds(theta_t), jocp.bounds(theta_j)):
        _close(a, b, rtol=0)
    _close(tocp.initial_guess(theta_t), jocp.initial_guess(theta_j), rtol=0)
    _close(tocp.shift_guess(torch.as_tensor(w), theta_t),
           jocp.shift_guess(jnp.asarray(w), theta_j), rtol=0)
    tj = jocp.trajectories(jnp.asarray(w), theta_j)
    tt = to_numpy(tocp.trajectories(torch.as_tensor(w), theta_t))
    assert set(tt) == set(tj)
    for k in tj:
        _close(tt[k], tj[k])


def test_default_params_match(ocps):
    jocp, tocp = ocps
    tp = tocp.default_params(device="cpu", dtype=F64, t0=600.0)
    jp = jocp.default_params(t0=600.0)
    for k in jp._fields:
        _close(getattr(tp, k), getattr(jp, k), rtol=0)
    assert tp.x0.dtype == F64 and tp.x0.device.type == "cpu"


# ---- multiple shooting -------------------------------------------------------

SHOOT_N = 4


def _shooting_pair(integrator="rk4"):
    from agentlib_mpc_tpu.ops.transcription import transcribe as jtranscribe
    from agentlib_mpc_torch.ops.transcription import transcribe

    kw = dict(N=SHOOT_N, dt=900.0, method="multiple_shooting",
              integrator=integrator, integrator_substeps=3)
    return (jtranscribe(jzoo.ZoneWithSupply(), ["mDot"], **kw),
            transcribe(zoo.ZoneWithSupply(), ["mDot"], **kw))


@pytest.fixture(scope="module")
def shooting():
    """Both shooting transcriptions and a random point (w, θ) in both
    forms."""
    jocp, tocp = _shooting_pair()
    rng = np.random.default_rng(17)
    theta_j = jocp.default_params(
        x0=jnp.asarray([rng.uniform(294.0, 300.0)]),
        d_traj=jnp.stack([jnp.asarray(rng.uniform(80, 250, size=SHOOT_N)),
                          jnp.full(SHOOT_N, 290.15),
                          jnp.full(SHOOT_N, 294.15)], -1),
        t0=jnp.asarray(1800.0))
    theta_t = ocp_params_from_numpy(
        {k: np.asarray(v) for k, v in theta_j._asdict().items()}, "cpu", F64)
    lb, ub = jocp.bounds(theta_j)
    w = np.asarray(lb) + rng.uniform(0.1, 0.9, size=jocp.n_w) * np.minimum(
        np.asarray(ub) - np.asarray(lb), 20.0)
    return jocp, tocp, w, theta_j, theta_t


def test_shooting_sizes_layout_and_partition(shooting):
    """Sizes, the flat key order u, x, z (no collocation states) and the
    stage partition (KKT n_w + n_g, blocks of 5) equal the JAX package's."""
    jocp, tocp, _, _, _ = shooting
    assert (tocp.n_w, tocp.n_g, tocp.n_h) == (jocp.n_w, jocp.n_g, jocp.n_h)
    w = np.arange(tocp.n_w, dtype=np.float64)
    jparts = jocp.unflatten(jnp.asarray(w))
    tparts = tocp.unflatten(torch.as_tensor(w))
    assert list(tparts) == ["u", "x", "z"]
    for k in tparts:
        np.testing.assert_array_equal(tparts[k].numpy(),
                                      np.asarray(jparts[k]))
    np.testing.assert_array_equal(tocp.flatten(tparts).numpy(), w)
    assert tuple(tocp.stage_partition) == tuple(jocp.stage_partition)
    assert tocp.stage_partition.block == 5
    assert tocp.stage_partition.n_total == tocp.n_w + tocp.n_g


def test_collocation_partition_matches_jax(ocps):
    jocp, tocp = ocps
    assert tuple(tocp.stage_partition) == tuple(jocp.stage_partition)
    assert tocp.stage_partition.n_total == tocp.n_w + tocp.n_g == 92


@pytest.mark.parametrize("fn", ["f", "g", "h"])
def test_shooting_values_and_jacobians_match(shooting, fn):
    jocp, tocp, w, theta_j, theta_t = shooting
    jf = getattr(jocp.nlp, fn)
    tf = getattr(tocp.nlp, fn)
    wt = torch.as_tensor(w, dtype=F64)
    _close(tf(wt, theta_t), jf(jnp.asarray(w), theta_j))
    _close(jacrev(tf)(wt, theta_t), jax.jacrev(jf)(jnp.asarray(w), theta_j))


@pytest.mark.parametrize("integrator", ["euler", "implicit_midpoint"])
def test_shooting_defects_with_other_integrators(shooting, integrator):
    """The defects through the explicit Euler and the implicit midpoint
    steppers (Newton solves inside the constraint function) and their
    Jacobians."""
    jocp, tocp = _shooting_pair(integrator)
    _, _, w, theta_j, theta_t = shooting
    wt = torch.as_tensor(w, dtype=F64)
    _close(tocp.nlp.g(wt, theta_t), jocp.nlp.g(jnp.asarray(w), theta_j))
    _close(jacrev(tocp.nlp.g)(wt, theta_t),
           jax.jacrev(jocp.nlp.g)(jnp.asarray(w), theta_j), rtol=1e-10)


def test_shooting_bounds_guess_shift_and_trajectories_match(shooting):
    jocp, tocp, w, theta_j, theta_t = shooting
    for a, b in zip(tocp.bounds(theta_t), jocp.bounds(theta_j)):
        _close(a, b, rtol=0)
    _close(tocp.initial_guess(theta_t), jocp.initial_guess(theta_j), rtol=0)
    _close(tocp.shift_guess(torch.as_tensor(w), theta_t),
           jocp.shift_guess(jnp.asarray(w), theta_j), rtol=0)
    tj = jocp.trajectories(jnp.asarray(w), theta_j)
    tt = to_numpy(tocp.trajectories(torch.as_tensor(w), theta_t))
    assert set(tt) == set(tj)
    for k in tj:
        _close(tt[k], tj[k])
