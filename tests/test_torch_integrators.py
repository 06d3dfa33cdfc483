"""The port's ODE integrators (``agentlib_mpc_torch/ops/integrators.py``)
and ``Model.simulate_step`` against the JAX package's.

Every stepper runs on a batch of random states (numpy, seeded) of the
zoo's ODEs with per-lane inputs and parameters, and on a stiff two-state
linear system; the JAX package runs each lane through ``jax.vmap``.
Float64 on the CPU; values agree to 1e-12 relative (the same arithmetic in
another framework; the Newton solves of the implicit methods add
``linalg.solve`` round-off). The adaptive integrator must take the same
accepted and rejected step counts per lane as the JAX package's vmapped
``while_loop``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agentlib_mpc_tpu.models import zoo as jzoo
from agentlib_mpc_tpu.ops import integrators as ji
from agentlib_mpc_torch.models import zoo
from agentlib_mpc_torch.ops import integrators as ti

from _torch_threads import one_torch_thread  # noqa: F401

F64 = torch.float64
RTOL = 1e-12
ZOO = ["ZoneWithSupply", "OneRoom", "LinearRCZone", "CooledRoom"]
B = 5


def _close(a, b, rtol=RTOL):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    np.testing.assert_allclose(a, b, rtol=rtol,
                               atol=rtol * max(1.0, float(np.abs(b).max(
                                   initial=0.0))))


def _zoo_lanes(name, seed=0):
    """(jax model, port model, x (B, n_x), z, u, p) at random points."""
    jm, tm = getattr(jzoo, name)(), getattr(zoo, name)()
    rng = np.random.default_rng(seed)
    x = rng.uniform(290.0, 300.0, size=(B, jm.n_diff))
    z = rng.uniform(-1.0, 1.0, size=(B, jm.n_free))
    u = np.asarray(jm.default_vector("inputs")) * rng.uniform(
        0.5, 1.5, size=(B, len(jm.input_names)))
    p = np.asarray(jm.default_vector("parameters")) * rng.uniform(
        0.5, 1.5, size=(B, len(jm.parameter_names)))
    return jm, tm, x, z, u, p


def _zoo_odes(jm, tm, z, u, p):
    """Per-lane JAX right-hand side (for vmap) and the port's batched one."""
    tz, tu, tp = (torch.as_tensor(a) for a in (z, u, p))

    def f_jax(zl, ul, pl):
        return lambda x, t: jm.ode(x, zl, ul, pl, t)

    def f_torch(x, t):
        return tm.ode(x.T, tz.T, tu.T, tp.T, t).T

    return f_jax, f_torch


# stiff linear test system x' = A x + c sin(t/100): eigenvalues -1/50 and
# -1/0.05 (s⁻¹), forcing on the slow state
_A = np.array([[-0.02, 0.5], [0.0, -20.0]])
_C = np.array([0.1, 0.0])


def _stiff_jax(x, t):
    return jnp.asarray(_A) @ x + jnp.asarray(_C) * jnp.sin(t / 100.0)


def _stiff_torch(x, t):
    t = torch.as_tensor(t, dtype=x.dtype)
    return x @ torch.as_tensor(_A).T + torch.as_tensor(_C) * \
        torch.sin(t / 100.0)[..., None]


FIXED = ["euler", "rk4", "implicit_midpoint", "trbdf2"]


@pytest.mark.parametrize("name", ZOO)
@pytest.mark.parametrize("method", FIXED)
def test_steppers_match_jax_on_zoo_odes(name, method):
    jm, tm, x, z, u, p = _zoo_lanes(name, seed=ZOO.index(name))
    f_jax, f_torch = _zoo_odes(jm, tm, z, u, p)
    h, t = 120.0, 600.0
    if method == "trbdf2":
        jx, jest = jax.vmap(lambda x_, z_, u_, p_: ji.trbdf2_step(
            f_jax(z_, u_, p_), x_, t, h))(*(jnp.asarray(a)
                                            for a in (x, z, u, p)))
        tx, test = ti.trbdf2_step(f_torch, torch.as_tensor(x), t, h)
        _close(test.numpy(), np.asarray(jest))
    else:
        jstep = getattr(ji, f"{method}_step")
        jx = jax.vmap(lambda x_, z_, u_, p_: jstep(
            f_jax(z_, u_, p_), x_, t, h))(*(jnp.asarray(a)
                                            for a in (x, z, u, p)))
        tx = getattr(ti, f"{method}_step")(f_torch, torch.as_tensor(x), t, h)
    assert tx.shape == x.shape
    _close(tx.numpy(), np.asarray(jx))


@pytest.mark.parametrize("method", FIXED + ["adaptive"])
def test_integrate_matches_jax_on_a_stiff_system(method):
    """Two coupled states with a 1000:1 stiffness ratio: every integrator
    (3 sub-steps for the fixed ones; explicit ones on a step their
    stability allows), per-lane start times as a tensor."""
    rng = np.random.default_rng(4)
    x0 = rng.normal(size=(B, 2))
    t0 = rng.uniform(0.0, 100.0, size=B)
    dt = {"euler": 0.09, "rk4": 0.09, "adaptive": 4.0}.get(method, 30.0)
    if method == "adaptive":
        # per-lane step counts too; the lanes finish apart
        x0 = x0 * rng.uniform(0.1, 10.0, size=(B, 1))
        jx, jcounts = jax.vmap(lambda x, t: ji.integrate_adaptive(
            _stiff_jax, x, t, dt))(jnp.asarray(x0), jnp.asarray(t0))
        tx, tcounts = ti.integrate_adaptive(
            _stiff_torch, torch.as_tensor(x0), torch.as_tensor(t0), dt)
        assert len(set(np.asarray(jcounts[0]).tolist())) > 1
        for a, b in zip(tcounts, jcounts):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    else:
        jx = jax.vmap(lambda x, t: ji.integrate(_stiff_jax, x, t, dt,
                                                substeps=3, method=method))(
            jnp.asarray(x0), jnp.asarray(t0))
        tx = ti.integrate(_stiff_torch, torch.as_tensor(x0),
                          torch.as_tensor(t0), dt, substeps=3, method=method)
    _close(tx.numpy(), np.asarray(jx))


@pytest.mark.parametrize("name", ["ZoneWithSupply", "LinearRCZone"])
def test_integrate_adaptive_matches_jax_step_counts(name):
    """Per-lane accepted/rejected step counts equal the vmapped
    ``while_loop``'s: lanes finish at different counts, and the
    batch-first loop freezes each where it stopped."""
    jm, tm, x, z, u, p = _zoo_lanes(name, seed=9)
    f_jax, f_torch = _zoo_odes(jm, tm, z, u, p)
    jx, (jacc, jrej) = jax.vmap(lambda x_, z_, u_, p_: ji.integrate_adaptive(
        f_jax(z_, u_, p_), x_, 0.0, 900.0))(
        *(jnp.asarray(a) for a in (x, z, u, p)))
    tx, (tacc, trej) = ti.integrate_adaptive(f_torch, torch.as_tensor(x),
                                             0.0, 900.0)
    np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))
    np.testing.assert_array_equal(trej.numpy(), np.asarray(jrej))
    _close(tx.numpy(), np.asarray(jx))


def test_integrate_adaptive_poisons_lanes_out_of_budget():
    """A lane that cannot reach t0+dt within max_steps returns NaN, as in
    the JAX package; the others are unaffected."""
    x0 = np.array([[1.0, 0.0], [1e-6, 0.0]])
    kw = dict(rtol=1e-12, atol=1e-14, max_steps=6)
    jx, _ = jax.vmap(lambda x_: ji.integrate_adaptive(
        _stiff_jax, x_, 0.0, 50.0, **kw))(jnp.asarray(x0))
    tx, (acc, _) = ti.integrate_adaptive(_stiff_torch, torch.as_tensor(x0),
                                         0.0, 50.0, **kw)
    np.testing.assert_array_equal(np.isnan(tx.numpy()),
                                  np.isnan(np.asarray(jx)))
    assert np.isnan(tx.numpy()).any()
    with pytest.raises(ValueError, match="unknown integrator"):
        ti.integrate(_stiff_torch, torch.as_tensor(x0), 0.0, 1.0,
                     method="cvodes")


@pytest.mark.parametrize("method", ["euler", "rk4", "implicit_midpoint",
                                    "trbdf2", "adaptive"])
def test_simulate_step_matches_jax(method):
    """One plant step of a batch of zones (batch-first: state on the last
    axis) against the JAX package's per-zone ``simulate_step``."""
    jm, tm, x, _, u, p = _zoo_lanes("ZoneWithSupply", seed=13)
    substeps = 4
    jx, jy = jax.vmap(lambda x_, u_, p_: jm.simulate_step(
        x_, u_, p_, 900.0, substeps=substeps, method=method))(
        *(jnp.asarray(a) for a in (x, u, p)))
    tx, ty = tm.simulate_step(torch.as_tensor(x), torch.as_tensor(u),
                              torch.as_tensor(p), 900.0, substeps=substeps,
                              method=method)
    assert tx.shape == (B, 1) and ty.shape == (B, 1)
    _close(tx.numpy(), np.asarray(jx))
    _close(ty.numpy(), np.asarray(jy))
    # one plant, 1-D arguments, the JAX package's own signature
    x1, y1 = tm.simulate_step(torch.as_tensor(x[0]), torch.as_tensor(u[0]),
                              torch.as_tensor(p[0]), 900.0,
                              substeps=substeps, method=method)
    _close(x1.numpy(), np.asarray(jx[0]))
    _close(y1.numpy(), np.asarray(jy[0]))


def test_simulate_step_takes_dtype_and_device_from_its_inputs():
    """No global flag: float32 in, float32 out, on the inputs' device;
    shared parameters broadcast over the batch."""
    tm = zoo.ZoneWithSupply()
    x = torch.full((3, 1), 297.0, dtype=torch.float32)
    u = torch.tensor([[0.02, 150.0, 290.15, 294.15]] * 3,
                     dtype=torch.float32)
    p = tm.default_vector("parameters", device="cpu", dtype=torch.float32)
    xn, y = tm.simulate_step(x, u, p, 300.0)
    assert xn.dtype == torch.float32 and y.dtype == torch.float32
    assert xn.device.type == "cpu"
    x64, _ = tm.simulate_step(x.double(), u.double(), p.double(), 300.0)
    assert x64.dtype == F64
    np.testing.assert_allclose(xn.numpy(), x64.numpy(), rtol=1e-6)
