"""The port's consensus-ADMM control step against ``bench.build_step``.

Four zones in float64 on the CPU with ``kkt_method="ldl"`` (the plain LDLᵀ
versions): one cold step and one warm step through both packages must give
equal per-lane interior-point iteration counts and agree on w, y, z, z̄ and
the multipliers to 1e-8 relative (the solves are identical algorithms; the
tolerance covers f64 round-off carried through 2 x 10 ADMM iterations).
(The short-horizon steps on the stage sweep and the stage-sparse
derivatives are in ``tests/test_torch_admm_step_day_ahead.py``.) The
linear fleet through the QP fast path
(``model="linear", inner="qp"``) against ``bench.build_step(model=
"linear", inner="qp")``, four zones, the same gates. Also: the ADMM operators against
``agentlib_mpc_tpu/ops/admm.py``, the copied workload constants against
``bench.py``, and the numpy carriers of ``utils/convert.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from agentlib_mpc_tpu.ops import admm as jadmm
from agentlib_mpc_torch.ops import admm as tadmm
from agentlib_mpc_torch.parallel import admm_step
from agentlib_mpc_torch.utils.convert import (
    fleet_args_from_numpy,
    ocp_params_from_numpy,
    to_numpy,
)

from _torch_threads import one_torch_thread  # noqa: F401

F64 = torch.float64
RTOL = 1e-8
N_ZONES = 4


def test_workload_constants_equal_bench():
    for name in ("N_AGENTS", "HORIZON", "ADMM_ITERS", "DT", "SOLVER_BASE",
                 "COLD_BUDGET", "WARM_BUDGET", "COLD_MU", "WARM_MU",
                 "ZONE_X0_RANGE", "ZONE_LOAD_RANGE"):
        assert getattr(admm_step, name) == getattr(bench, name), name
    _, d_row, zbar0, rho0 = bench._MODELS["zone"]
    assert tuple(d_row(0.0)[1:]) == admm_step.ZONE_D_ROW_TAIL
    assert (zbar0, rho0) == (admm_step.ZONE_ZBAR0, admm_step.ZONE_RHO0)
    _, d_row, zbar0, rho0 = bench._MODELS["linear"]
    assert tuple(d_row(0.0)[1:]) == admm_step.LINEAR_D_ROW_TAIL
    assert (zbar0, rho0) == (admm_step.LINEAR_ZBAR0, admm_step.LINEAR_RHO0)
    for model, (_, tail, z0, r0) in admm_step.MODELS.items():
        _, d_row, zbar0, rho0 = bench._MODELS[model]
        assert (tuple(d_row(0.0)[1:]), zbar0, rho0) == (tail, z0, r0)
    for a, b in zip(admm_step.fleet_inputs(7), bench.fleet_inputs(7)):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def both_steps():
    """One cold + one warm control step through each package."""
    jstep, jargs = bench.build_step(N_ZONES, {"kkt_method": "ldl"},
                                    record_stats=True)
    jout, jstats = jstep(*jargs)
    jout2, jstats2 = bench.warm_step(jstep, jargs, jout)
    step, args = admm_step.build_step(N_ZONES, {"kkt_method": "ldl"},
                                      device="cpu", dtype=F64,
                                      record_stats=True)
    for a, b in zip(args, jargs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    out, stats = step(*args)
    out2, stats2 = admm_step.warm_step(step, args, out)
    return ((jout, jstats), (jout2, jstats2)), ((out, stats), (out2, stats2))


@pytest.mark.parametrize("which", [0, 1], ids=["cold", "warm"])
def test_control_step_matches_bench(both_steps, which):
    (jout, jstats), (out, stats) = both_steps[0][which], both_steps[1][which]
    # per-lane interior-point iterations of every ADMM iteration
    np.testing.assert_array_equal(stats[2].numpy(), np.asarray(jstats[2]))
    np.testing.assert_array_equal(stats[3].numpy(), np.asarray(jstats[3]))
    for name, a, b in zip(("w", "y", "z", "zbar", "lams"), jout, out):
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, rtol=RTOL,
                                   atol=RTOL * np.abs(a).max(), err_msg=name)
    # Boyd residuals per ADMM iteration
    for k in (0, 1):
        np.testing.assert_allclose(stats[k].numpy(), np.asarray(jstats[k]),
                                   rtol=1e-6, atol=1e-10)


def test_control_step_runs_from_converted_jax_state(both_steps):
    """The JAX package's warm-start state carried over as numpy drives the
    port's step to the JAX package's next state."""
    (jout, _), (jout2, _) = both_steps[0]
    jargs = bench.build_step(N_ZONES, {"kkt_method": "ldl"})[1]
    state = [np.asarray(a) for a in jargs]
    state[2:7] = [np.asarray(a) for a in jout]
    args = fleet_args_from_numpy(state, "cpu", F64)
    step, _ = admm_step.build_step(N_ZONES, {"kkt_method": "ldl"},
                                   device="cpu", dtype=F64)
    out = to_numpy(step(*args))
    for a, b in zip(jout2, out):
        a = np.asarray(a)
        np.testing.assert_allclose(b, a, rtol=RTOL,
                                   atol=RTOL * np.abs(a).max())
    with pytest.raises(ValueError):
        fleet_args_from_numpy(state[:7], "cpu", F64)


def test_ocp_params_round_trip():
    ocp = admm_step.zone_ocp()
    theta = ocp.default_params(device="cpu", dtype=F64)
    back = ocp_params_from_numpy(to_numpy(theta._asdict()), "cpu", F64)
    for a, b in zip(theta, back):
        assert torch.equal(a, b)
    with pytest.raises(KeyError):
        ocp_params_from_numpy({"x0": np.zeros(1)}, "cpu", F64)


@pytest.mark.parametrize("masked", [False, True])
def test_consensus_update_matches_jax(masked):
    rng = np.random.default_rng(11)
    locals_ = rng.normal(size=(6, 10, 1))
    zbar = rng.normal(size=(10, 1))
    lam = rng.normal(size=(6, 10, 1))
    active = np.array([1, 1, 0, 1, 0, 1], bool) if masked else None
    jst, jres = jadmm.consensus_update(
        jnp.asarray(locals_),
        jadmm.ConsensusState(jnp.asarray(zbar), jnp.asarray(lam),
                             jnp.asarray(0.7)),
        None if active is None else jnp.asarray(active))
    tst, tres = tadmm.consensus_update(
        torch.as_tensor(locals_),
        tadmm.ConsensusState(torch.as_tensor(zbar), torch.as_tensor(lam),
                             torch.tensor(0.7, dtype=F64)),
        None if active is None else torch.as_tensor(active))
    for a, b in zip(jst, tst):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-12)
    for a, b in zip(jres, tres):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-12)
    assert bool(tadmm.converged(tres)) == bool(jadmm.converged(jres))
    assert bool(tadmm.converged(tres, use_relative=False)) == \
        bool(jadmm.converged(jres, use_relative=False))
    np.testing.assert_allclose(
        tadmm.consensus_penalty(torch.as_tensor(locals_[0]),
                                torch.as_tensor(zbar),
                                torch.as_tensor(lam[0]), 0.7).numpy(),
        np.asarray(jadmm.consensus_penalty(jnp.asarray(locals_[0]),
                                           jnp.asarray(zbar),
                                           jnp.asarray(lam[0]), 0.7)),
        rtol=1e-12)


STAGE_ZONES, STAGE_N, STAGE_DT = 2, 3, 900.0


@pytest.fixture(scope="module")
def linear_qp_steps():
    """One cold + one warm step of the linear fleet through the QP fast
    path in each package."""
    jstep, jargs = bench.build_step(N_ZONES, {"kkt_method": "ldl"},
                                    model="linear", inner="qp",
                                    record_stats=True)
    jout, jstats = jstep(*jargs)
    jout2, jstats2 = bench.warm_step(jstep, jargs, jout)
    step, args = admm_step.build_step(N_ZONES, {"kkt_method": "ldl"},
                                      device="cpu", dtype=F64,
                                      record_stats=True, model="linear",
                                      inner="qp")
    for a, b in zip(args, jargs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    out, stats = step(*args)
    out2, stats2 = admm_step.warm_step(step, args, out)
    return ((jout, jstats), (jout2, jstats2)), ((out, stats), (out2, stats2))


@pytest.mark.parametrize("which", [0, 1], ids=["cold", "warm"])
def test_linear_qp_step_matches_bench(linear_qp_steps, which):
    from agentlib_mpc_torch.ops.solver import JAC_PATHS, KKT_PATHS

    (jout, jstats), (out, stats) = linear_qp_steps[0][which], \
        linear_qp_steps[1][which]
    assert bool((stats[5] == KKT_PATHS.index("ldl")).all())
    assert bool((stats[6] == JAC_PATHS.index("dense")).all())
    np.testing.assert_array_equal(stats[2].numpy(), np.asarray(jstats[2]))
    np.testing.assert_array_equal(stats[3].numpy(), np.asarray(jstats[3]))
    for name, a, b in zip(("w", "y", "z", "zbar", "lams"), jout, out):
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, rtol=RTOL,
                                   atol=RTOL * np.abs(a).max(), err_msg=name)
    for k in (0, 1):
        np.testing.assert_allclose(stats[k].numpy(), np.asarray(jstats[k]),
                                   rtol=1e-6, atol=1e-10)
