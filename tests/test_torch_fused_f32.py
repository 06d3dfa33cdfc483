"""The fused linear fleet in float32: the port's FusedADMM against the JAX
package's, on the CPU.

Eight ``LinearRCZone`` zones with ``bench.py``'s linear options (N=10,
cold budget 10 with the Mehrotra corrector, warm budget 1, ρ 5e-3),
routed to the QP, with the Boyd exits pinned to zero so that every run
takes exactly 10 ADMM iterations: two rounds from one state, each on the
plain LDLᵀ, through the JAX package in float32 (x64 off) and float64 and
through the port in float32 and float64.

float32 round-off moves these budget-limited iterates by watts (the
controls are cooling powers in 0..500 W), so float32 rounds are held to
the linear fleet's gates of ``chip_smoke.py`` (``QP_ZBAR_TOL``,
``QP_U_MEDIAN_TOL``): z̄ within 25 W and the median |Δu| within 2 W,

- the port's float32 rounds against the JAX package's float32 rounds;
- each package's float32 rounds against the JAX package's float64 rounds
  (its run-off, which both packages must show alike).

Measured on the CPU (``scripts/fused_linear_f32.py 8``): port f32 vs
JAX f32 z̄ 7.1 / 6.1 W apart, median |Δu| 0.47 / 0.77 W; run-off z̄
7.8 / 6.2 W (port) and 2.4 / 1.9 W (JAX), median 0.69 / 0.50 W and
0.74 / 0.21 W. At 16 zones both packages' float32 rounds run off float64
by hundreds of watts (the same script; ROADMAP Queue 3). The float64
rounds agree within 1e-8 relative, as in ``test_torch_fused_fleets``.
"""

import jax
import numpy as np
import pytest
import torch

from test_torch_fused_fleets import build

from _torch_threads import one_torch_thread  # noqa: F401

N_ZONES = 8
ROUNDS = 2
ZBAR_TOL_W, U_MEDIAN_TOL_W = 25.0, 2.0
F64_RTOL = 1e-8


def run(pkg, dtype):
    """(routing verdicts, [(z̄, u, iterations) per round]) of one package
    at one precision (the JAX package's from the x64 flag in force, checked
    against ``dtype``); numpy float64 out."""
    engine, thetas, alias = build(pkg, "linear", N_ZONES, dtype, pinned=True)
    state = engine.init_state(thetas)
    rounds = []
    for _ in range(ROUNDS):
        state, trajs, stats = engine.step(state, thetas)
        zbar, u = state.zbar[alias], trajs[0]["u"][..., 0]
        if pkg == "t":
            zbar, u = zbar.numpy(), u.numpy()
        assert zbar.dtype == u.dtype == \
            np.dtype(str(dtype).removeprefix("torch."))
        rounds.append((np.asarray(zbar, np.float64),
                       np.asarray(u, np.float64), int(stats.iterations)))
    return engine.group_uses_qp, rounds


@pytest.fixture(scope="module")
def fleets():
    with jax.enable_x64(False):
        j32 = run("j", torch.float32)
    return {"jax f32": j32, "jax f64": run("j", torch.float64),
            "port f32": run("t", torch.float32),
            "port f64": run("t", torch.float64)}


def gaps(a, b):
    return (float(np.abs(a[0] - b[0]).max()),
            float(np.median(np.abs(a[1] - b[1]))))


def test_every_run_is_routed_to_the_qp_and_pinned(fleets):
    for verdict, rounds in fleets.values():
        assert verdict == (True,)
        assert [r[2] for r in rounds] == [10] * ROUNDS


@pytest.mark.parametrize("k", range(ROUNDS), ids=["round0", "round1"])
def test_port_f32_matches_jax_f32(fleets, k):
    zbar, u_median = gaps(fleets["port f32"][1][k], fleets["jax f32"][1][k])
    assert zbar <= ZBAR_TOL_W and u_median <= U_MEDIAN_TOL_W, (zbar, u_median)


@pytest.mark.parametrize("pkg", ["port", "jax"])
@pytest.mark.parametrize("k", range(ROUNDS), ids=["round0", "round1"])
def test_f32_run_off_from_f64_within_the_linear_gates(fleets, pkg, k):
    zbar, u_median = gaps(fleets[f"{pkg} f32"][1][k], fleets["jax f64"][1][k])
    assert zbar <= ZBAR_TOL_W and u_median <= U_MEDIAN_TOL_W, (zbar, u_median)


@pytest.mark.parametrize("k", range(ROUNDS), ids=["round0", "round1"])
def test_port_f64_matches_jax_f64(fleets, k):
    (pz, pu, _), (jz, ju, _) = (fleets["port f64"][1][k],
                                fleets["jax f64"][1][k])
    for a, b in ((pz, jz), (pu, ju)):
        np.testing.assert_allclose(a, b, rtol=F64_RTOL,
                                   atol=F64_RTOL * np.abs(b).max())
