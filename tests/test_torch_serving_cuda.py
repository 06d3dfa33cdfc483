"""The serving plane on the card (marker ``cuda``; it skips without one).
This file imports no JAX, so it runs on a machine that has only the port.

Eight ``LinearRCZone`` tenants (``bench.py --serve``'s workload at a small
size, built as ``chip_smoke.serve_workload`` builds it) join a plane on
the card in float32 and in float64; two rounds each deliver finite
actuated controls, both LDLᵀ kernels launch at the bucket's capacity, and
the f64 plane's controls equal a CPU plane's within 1e-6 W.
"""

import pytest
import torch

from agentlib_mpc_torch.ops import kkt
from agentlib_mpc_torch.ops.solver import SolverOptions
from agentlib_mpc_torch.parallel import admm_step
from agentlib_mpc_torch.parallel.fused_admm import FusedADMMOptions
from agentlib_mpc_torch.serving import ServingPlane, TenantSpec

from _torch_threads import one_torch_thread  # noqa: F401

N_TENANTS = 8
#: u0 of the card's f64 plane against the CPU's (watts)
F64_U_TOL = 1e-6


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")


def _serve(device, dtype, rounds=2):
    ocp = admm_step.linear_zone_ocp()
    base = ocp.default_params(device="cpu", dtype=dtype)
    d_traj = torch.tensor([150.0, 303.15, 295.15], dtype=dtype).expand(
        ocp.N, 3).clone()
    plane = ServingPlane(FusedADMMOptions(max_iterations=5, rho=5e-3),
                         initial_capacity=N_TENANTS, pipelined=False,
                         device=device, dtype=dtype)
    for i in range(N_TENANTS):
        plane.join(TenantSpec(
            tenant_id=f"t{i}", ocp=ocp,
            theta=base._replace(x0=torch.tensor([294.0 + i], dtype=dtype),
                                d_traj=d_traj),
            couplings={"power": "Q"},
            solver_options=SolverOptions(**admm_step.SOLVER_BASE)))
    out = []
    for _ in range(rounds):
        for tid in plane.tenants:
            plane.submit(tid)
        out.append(plane.serve_round())
    return out


@pytest.mark.cuda
def test_plane_on_the_card_launches_both_kernels(card):
    kkt.reset_launch_counts()
    rounds = _serve(None, torch.float32)
    assert kkt.ldl_factor.launches > 0 and kkt.ldl_solve.launches > 0
    assert (N_TENANTS, 92) in kkt.ldl_factor.shapes
    for res in rounds:
        assert len(res) == N_TENANTS
        for r in res.values():
            assert r.action == "actuate"
            assert torch.isfinite(torch.tensor(r.controls["Q"]))


@pytest.mark.cuda
def test_f64_plane_on_the_card_equals_the_cpu(card):
    card_rounds = _serve(None, torch.float64)
    cpu_rounds = _serve("cpu", torch.float64)
    for card_res, cpu_res in zip(card_rounds, cpu_rounds):
        for tid, r in card_res.items():
            assert r.action == cpu_res[tid].action
            assert abs(r.controls["Q"] - cpu_res[tid].controls["Q"]) \
                <= F64_U_TOL
