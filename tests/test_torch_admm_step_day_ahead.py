"""The port's consensus-ADMM control step against ``bench.build_step`` at
a short horizon on the day-ahead paths.

Two zones at N=3, dt=900 s in float64 on the CPU: on the stage sweep
(``kkt_method="stage"``, each package's own partition passed in the
solver overrides; ``bench.HORIZON``/``bench.DT`` monkeypatched, which
``bench.build_step`` reads at call time), and there on the stage-sparse
derivative pipeline (``jacobian="sparse"``: the port certifies and
attaches its plan, the JAX side gets its own plan built from the same
partition and rows); one cold and one warm step each, with equal per-lane
interior-point iterations and w, y, z, z̄ and the multipliers within 1e-8
relative. Split from ``tests/test_torch_admm_step.py``, whose N=10 steps
it shares no fixture with.
"""

import numpy as np
import pytest
import torch

import bench
from agentlib_mpc_torch.parallel import admm_step

from _torch_threads import one_torch_thread  # noqa: F401

F64 = torch.float64
RTOL = 1e-8
STAGE_ZONES, STAGE_N, STAGE_DT = 2, 3, 900.0


@pytest.fixture(scope="module")
def stage_steps():
    """One cold + one warm control step at N=3 on the stage sweep through
    each package."""
    mp = pytest.MonkeyPatch()
    mp.setattr(bench, "HORIZON", STAGE_N)
    mp.setattr(bench, "DT", STAGE_DT)
    try:
        jpart = bench.zone_ocp().stage_partition
        jstep, jargs = bench.build_step(
            STAGE_ZONES, {"kkt_method": "stage", "stage_partition": jpart},
            record_stats=True)
        jout, jstats = jstep(*jargs)
        jout2, jstats2 = bench.warm_step(jstep, jargs, jout)
    finally:
        mp.undo()
    tpart = admm_step.zone_ocp(STAGE_N, STAGE_DT).stage_partition
    step, args = admm_step.build_step(
        STAGE_ZONES, {"kkt_method": "stage", "stage_partition": tpart},
        device="cpu", dtype=F64, record_stats=True, horizon=STAGE_N,
        dt=STAGE_DT)
    for a, b in zip(args, jargs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    out, stats = step(*args)
    out2, stats2 = admm_step.warm_step(step, args, out)
    return ((jout, jstats), (jout2, jstats2)), ((out, stats), (out2, stats2))


@pytest.mark.parametrize("which", [0, 1], ids=["cold", "warm"])
def test_stage_control_step_matches_bench(stage_steps, which):
    from agentlib_mpc_torch.ops.solver import KKT_PATHS

    (jout, jstats), (out, stats) = stage_steps[0][which], \
        stage_steps[1][which]
    assert bool((stats[5] == KKT_PATHS.index("stage")).all())
    np.testing.assert_array_equal(stats[2].numpy(), np.asarray(jstats[2]))
    np.testing.assert_array_equal(stats[3].numpy(), np.asarray(jstats[3]))
    for name, a, b in zip(("w", "y", "z", "zbar", "lams"), jout, out):
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, rtol=RTOL,
                                   atol=RTOL * np.abs(a).max(), err_msg=name)


def test_default_horizon_keeps_the_dense_paths():
    """At N=10 the attached partition changes nothing: KKT 92 is below
    stage_min_size, so "auto" stays LU on the CPU."""
    step, args = admm_step.build_step(2, device="cpu", dtype=F64,
                                      record_stats=True, cold_budget=1)
    from agentlib_mpc_torch.ops.solver import KKT_PATHS

    _, stats = step(*args)
    assert bool((stats[5] == KKT_PATHS.index("lu")).all())
    assert admm_step.zone_ocp().stage_partition.n_total == 92


@pytest.fixture(scope="module")
def sparse_steps():
    """One cold + one warm control step at N=3 on the stage-sparse
    derivative pipeline through each package."""
    from agentlib_mpc_tpu.ops.stagejac import build_stage_jacobian_plan

    tpart = admm_step.zone_ocp(STAGE_N, STAGE_DT).stage_partition
    step, args = admm_step.build_step(
        STAGE_ZONES, {"jacobian": "sparse"}, device="cpu", dtype=F64,
        record_stats=True, horizon=STAGE_N, dt=STAGE_DT)
    plan = step.solver_options.stage_jacobian_plan
    assert plan is not None and plan.partition == tpart
    mp = pytest.MonkeyPatch()
    mp.setattr(bench, "HORIZON", STAGE_N)
    mp.setattr(bench, "DT", STAGE_DT)
    try:
        jpart = bench.zone_ocp().stage_partition
        jplan = build_stage_jacobian_plan(jpart, plan.h_row_stages)
        jstep, jargs = bench.build_step(
            STAGE_ZONES, {"jacobian": "sparse", "stage_partition": jpart,
                          "stage_jacobian_plan": jplan},
            record_stats=True)
        jout, jstats = jstep(*jargs)
        jout2, jstats2 = bench.warm_step(jstep, jargs, jout)
    finally:
        mp.undo()
    out, stats = step(*args)
    out2, stats2 = admm_step.warm_step(step, args, out)
    return ((jout, jstats), (jout2, jstats2)), ((out, stats), (out2, stats2))


@pytest.mark.parametrize("which", [0, 1], ids=["cold", "warm"])
def test_sparse_control_step_matches_bench(sparse_steps, which):
    from agentlib_mpc_torch.ops.solver import JAC_PATHS, KKT_PATHS

    (jout, jstats), (out, stats) = sparse_steps[0][which], \
        sparse_steps[1][which]
    assert bool((stats[5] == KKT_PATHS.index("stage")).all())
    assert bool((stats[6] == JAC_PATHS.index("sparse")).all())
    np.testing.assert_array_equal(stats[2].numpy(), np.asarray(jstats[2]))
    np.testing.assert_array_equal(stats[3].numpy(), np.asarray(jstats[3]))
    for name, a, b in zip(("w", "y", "z", "zbar", "lams"), jout, out):
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, rtol=RTOL,
                                   atol=RTOL * np.abs(a).max(), err_msg=name)


@pytest.mark.parametrize("model", ["zone", "linear"])
def test_plan_attached_a_day_ahead_only(model):
    """The production seam: the certified plan is attached where "auto"
    can route sparse (N=96, KKT 866 on the sweep) and not at N=10 (KKT 92
    below jacobian_min_size)."""
    step96, _ = admm_step.build_step(2, device="cpu", dtype=F64, model=model,
                                     horizon=96, dt=900.0)
    plan = step96.solver_options.stage_jacobian_plan
    assert plan is not None and plan.partition.n_total == 866
    step10, _ = admm_step.build_step(2, device="cpu", dtype=F64, model=model)
    assert step10.solver_options.stage_jacobian_plan is None
    with pytest.raises(ValueError, match="model"):
        admm_step.build_step(2, device="cpu", model="tank")
    with pytest.raises(ValueError, match="inner"):
        admm_step.build_step(2, device="cpu", inner="simplex")
