"""The port's stage-structured KKT sweep (``agentlib_mpc_torch/ops/
stagewise.py``) against the JAX package's (``agentlib_mpc_tpu/ops/
stagewise.py``).

Inputs are made with numpy from a seed (``synthetic_stage_kkt``, the same
construction in both packages) and handed to both. The JAX side runs on
the CPU through its plain LDLᵀ reference, the port's on the plain PyTorch
versions. Tolerances: float64 to 1e-10 relative (the same recursions in
another summation order, carried through up to 97 stage Schur complements),
float32 at rtol 1e-4 (f32 round-off of the same sweep, amplified by the
blocks' conditioning). The stage factors themselves are compared, not only
the solutions: a padded pivot that reached the factor as 0 would be
clamped by ``_safe_d`` and could still give a plausible solution.
Card-only tests carry the ``cuda`` marker and skip without a card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agentlib_mpc_tpu.ops import solver as jsolver
from agentlib_mpc_tpu.ops import stagewise as js
from agentlib_mpc_torch.ops import kkt
from agentlib_mpc_torch.ops import solver as tsolver
from agentlib_mpc_torch.ops import stagewise as ts
from agentlib_mpc_torch.utils.convert import stage_partition_from_fields

from _torch_threads import one_torch_thread  # noqa: F401

F64 = torch.float64
RTOL64 = 1e-10
RTOL32 = 1e-4

#: (N, n_x, n_u, n_z, d, method, fix_initial_state)
LAYOUTS = [
    (6, 1, 1, 1, 2, "collocation", True),        # the zone at N=6
    (96, 1, 1, 1, 2, "collocation", True),       # the zone a day ahead
    (6, 1, 1, 1, 1, "multiple_shooting", True),
    (96, 1, 1, 1, 1, "multiple_shooting", True),
    (4, 2, 1, 0, 3, "collocation", False),       # MHE-style, no pin
    (3, 2, 2, 1, 1, "multiple_shooting", False),
    (1, 1, 1, 1, 2, "collocation", True),        # one interval
]


def _ids(layout):
    N, n_x, n_u, n_z, d, method, fix = layout
    return f"{method[:5]}-N{N}-x{n_x}u{n_u}z{n_z}d{d}-{'pin' if fix else 'free'}"


def _close(a, b, rtol):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    np.testing.assert_allclose(a, b, rtol=rtol,
                               atol=rtol * max(1.0, float(np.abs(b).max(
                                   initial=0.0))))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("layout", LAYOUTS, ids=_ids)
def test_partition_matches_jax(layout):
    N, n_x, n_u, n_z, d, method, fix = layout
    jp = js.build_stage_partition(N, n_x, n_u, n_z, d, method, fix)
    tp = ts.build_stage_partition(N, n_x, n_u, n_z, d, method, fix)
    assert tuple(tp) == tuple(jp)
    np.testing.assert_array_equal(ts.stage_of_index(tp),
                                  js.stage_of_index(jp))
    for a, b in zip(ts._perm_arrays(tp), js._perm_arrays(jp)):
        np.testing.assert_array_equal(a, b)
    # carried across as plain ints, the reference's partition is the port's
    assert stage_partition_from_fields(jp) == tp
    assert stage_partition_from_fields(jp._asdict()) == tp
    assert all(type(i) is int for i in stage_partition_from_fields(jp).perm)


def test_day_ahead_partition_sizes():
    """The sizes the day-ahead path is built for: KKT 866 of 97 stages of
    10 (collocation), 386 of 97 stages of 5 (shooting); the padding of
    every stage after the first."""
    colloc = ts.build_stage_partition(96, 1, 1, 1, 2, "collocation")
    shoot = ts.build_stage_partition(96, 1, 1, 1, 1, "multiple_shooting")
    assert (colloc.n_total, colloc.n_stages, colloc.block) == (866, 97, 10)
    assert (shoot.n_total, shoot.n_stages, shoot.block) == (386, 97, 5)
    for p, first, mid in ((colloc, 10, 9), (shoot, 5, 4)):
        per_stage = (np.asarray(p.perm).reshape(p.n_stages, p.block) >= 0
                     ).sum(1)
        assert per_stage[0] == first and per_stage[-1] == 1
        assert set(per_stage[1:-1].tolist()) == {mid}


def test_stage_of_index_rejects_non_covering_perm():
    p = ts.build_stage_partition(3, 1, 1, 1, 2, "collocation")
    perm = list(p.perm)
    perm[perm.index(0)] = -1
    with pytest.raises(ValueError, match="does not cover"):
        ts.stage_of_index(p._replace(perm=tuple(perm)))
    with pytest.raises(ValueError, match="unknown transcription"):
        ts.build_stage_partition(3, 1, 1, 1, 2, "pseudospectral")


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_system_equals_jax(seed):
    p = ts.build_stage_partition(5, 1, 1, 1, 2, "collocation")
    jp = js.build_stage_partition(5, 1, 1, 1, 2, "collocation")
    for a, b in zip(ts.synthetic_stage_kkt(p, seed),
                    js.synthetic_stage_kkt(jp, seed)):
        np.testing.assert_array_equal(a, b)


def _batch(layout, n, seed=0, dtype=np.float64):
    """n synthetic systems of the layout's partition, stacked."""
    N, n_x, n_u, n_z, d, method, fix = layout
    tp = ts.build_stage_partition(N, n_x, n_u, n_z, d, method, fix)
    jp = js.build_stage_partition(N, n_x, n_u, n_z, d, method, fix)
    Ks, rs = zip(*(ts.synthetic_stage_kkt(tp, seed + i, dtype)
                   for i in range(n)))
    return tp, jp, np.stack(Ks), np.stack(rs)


BLOCK_LAYOUTS = [LAYOUTS[0], LAYOUTS[2], LAYOUTS[4], LAYOUTS[6]]
#: the sweep's parity cases: the zone's collocation and shooting layouts
SWEEP_LAYOUTS = [LAYOUTS[0], LAYOUTS[2]]


@pytest.mark.parametrize("layout", BLOCK_LAYOUTS, ids=_ids)
def test_stage_blocks_layout_matches_jax(layout):
    """Batch-first block extraction: (B, S, ns, ns) diagonal and
    (B, S-1, ns, ns) sub-diagonal blocks, each lane equal to the JAX
    package's per-problem blocks exactly (a gather, no arithmetic)."""
    tp, jp, K, _ = _batch(layout, 3, seed=5)
    D, E = ts._stage_blocks(torch.as_tensor(K), tp)
    S, ns = tp.n_stages, tp.block
    assert D.shape == (3, S, ns, ns) and E.shape == (3, S - 1, ns, ns)
    for b in range(3):
        jD, jE = js._stage_blocks(jnp.asarray(K[b]), jp)
        np.testing.assert_array_equal(D[b].numpy(), np.asarray(jD))
        np.testing.assert_array_equal(E[b].numpy(), np.asarray(jE))
    # stage-major storage: one stage of the batch is contiguous
    assert D[:, 0].is_contiguous() and (S == 1 or E[:, 0].is_contiguous())


@pytest.mark.parametrize("layout", SWEEP_LAYOUTS, ids=_ids)
def test_factor_resolve_solve_match_jax_f64(layout):
    tp, jp, K, r = _batch(layout, 4, seed=11)
    jf = jax.vmap(lambda k: js.factor_kkt_stage(k, jp))(jnp.asarray(K))
    jx = jax.vmap(lambda f, b: js.resolve_kkt_stage(f, b, jp))(
        jf, jnp.asarray(r))
    tf = ts.factor_kkt_stage(torch.as_tensor(K), tp)
    tx = ts.resolve_kkt_stage(tf, torch.as_tensor(r), tp)
    # the stage factors, tril(LD) against the reference's lower triangle
    _close(tf[0].numpy(), np.tril(np.asarray(jf[0])), RTOL64)
    assert np.all(np.triu(tf[0].numpy(), 1) == 0.0)
    _close(tx.numpy(), np.asarray(jx), RTOL64)
    assert np.abs(np.einsum("bij,bj->bi", K, tx.numpy()) - r).max() < 1e-9
    np.testing.assert_array_equal(
        ts.solve_kkt_stage(torch.as_tensor(K), torch.as_tensor(r),
                           tp).numpy(), tx.numpy())


def test_factor_and_solve_match_jax_f32():
    layout = LAYOUTS[0]
    tp, jp, K, r = _batch(layout, 3, seed=2, dtype=np.float32)
    jf = jax.vmap(lambda k: js.factor_kkt_stage(k, jp))(
        jnp.asarray(K, dtype=jnp.float32))
    jx = jax.vmap(lambda f, b: js.resolve_kkt_stage(f, b, jp))(
        jf, jnp.asarray(r, dtype=jnp.float32))
    tf = ts.factor_kkt_stage(torch.as_tensor(K), tp)
    tx = ts.resolve_kkt_stage(tf, torch.as_tensor(r), tp)
    assert tx.dtype == torch.float32 and np.asarray(jx).dtype == np.float32
    _close(tf[0].numpy(), np.tril(np.asarray(jf[0])), RTOL32)
    _close(tx.numpy(), np.asarray(jx), RTOL32)


def test_leading_axes_flatten_into_the_batch():
    """(2, 3, M, M) factors as a batch of 6 and resolves back to (2, 3, M)."""
    tp, _, K, r = _batch(LAYOUTS[2], 6, seed=4)
    K4 = torch.as_tensor(K).reshape(2, 3, *K.shape[1:])
    r3 = torch.as_tensor(r).reshape(2, 3, -1)
    x = ts.solve_kkt_stage(K4, r3, tp)
    assert x.shape == (2, 3, tp.n_total)
    flat = ts.solve_kkt_stage(torch.as_tensor(K), torch.as_tensor(r), tp)
    np.testing.assert_array_equal(x.reshape(6, -1).numpy(), flat.numpy())


def test_mismatched_partition_raises():
    tp, _, K, _ = _batch(LAYOUTS[0], 1)
    other = ts.build_stage_partition(7, 1, 1, 1, 2, "collocation")
    with pytest.raises(ValueError, match="covers a"):
        ts.factor_kkt_stage(torch.as_tensor(K), other)


def _jax_blocks(K, jp):
    """The JAX package's (D, E) blocks of each matrix of K, stacked."""
    return jax.vmap(lambda k: js._stage_blocks(k, jp))(jnp.asarray(K))


def test_banded_variants_match_jax():
    """Factor and resolve from the (D, E) blocks alone, and the banded
    product, against the JAX package's banded entry points."""
    tp, jp, K, r = _batch(LAYOUTS[0], 3, seed=8)
    D, E = ts._stage_blocks(torch.as_tensor(K), tp)
    jD, jE = _jax_blocks(K, jp)
    rng = np.random.default_rng(1)
    xb = rng.normal(size=(3, tp.n_stages, tp.block))
    _close(ts.band_matvec_blocks(D, E, torch.as_tensor(xb)).numpy(),
           np.asarray(jax.vmap(js.band_matvec_blocks)(jD, jE,
                                                      jnp.asarray(xb))),
           RTOL64)
    tf = ts.factor_kkt_stage_banded(D.contiguous(), E.contiguous())
    tx = ts.resolve_kkt_stage_banded(tf, torch.as_tensor(r), tp)
    jf = jax.vmap(js.factor_kkt_stage_banded)(jD, jE)
    jx = jax.vmap(lambda f, b: js.resolve_kkt_stage_banded(f, b, jp))(
        jf, jnp.asarray(r))
    _close(tf[0].numpy(), np.tril(np.asarray(jf[0])), RTOL64)
    _close(tf[3].numpy(), np.asarray(jf[3]), RTOL64)
    _close(tx.numpy(), np.asarray(jx), RTOL64)
    assert np.abs(np.einsum("bij,bj->bi", K, tx.numpy()) - r).max() < 1e-9


@pytest.mark.parametrize("n_scen", [1, 3])
def test_scenario_variants_match_jax(n_scen):
    layout = LAYOUTS[0]
    tp, jp, K, r = _batch(layout, n_scen, seed=21)
    tf = ts.factor_kkt_scenarios(torch.as_tensor(K), tp)
    jf = js.factor_kkt_scenarios(jnp.asarray(K), jp)
    assert tf[0] == ("flat" if n_scen == 1 else "batch")
    _close(ts.resolve_kkt_scenarios(tf, torch.as_tensor(r), tp).numpy(),
           np.asarray(js.resolve_kkt_scenarios(jf, jnp.asarray(r), jp)),
           RTOL64)
    D, E = ts._stage_blocks(torch.as_tensor(K), tp)
    jD, jE = _jax_blocks(K, jp)
    tbf = ts.factor_kkt_scenarios_banded(D, E)
    jbf = js.factor_kkt_scenarios_banded(jD, jE)
    _close(ts.resolve_kkt_scenarios_banded(
        tbf, torch.as_tensor(r), tp).numpy(),
        np.asarray(js.resolve_kkt_scenarios_banded(jbf, jnp.asarray(r),
                                                   jp)), RTOL64)
    with pytest.raises(ValueError, match="n_scenarios"):
        ts.factor_kkt_scenarios(torch.as_tensor(K[0]), tp)


def test_many_rhs_solve_matches_row_solves_and_jax():
    """ldl_solve_many: one factor, R right-hand sides, equal to R single
    solves (bitwise: the same plain recursion, broadcast) and to the JAX
    package's vmapped row solves (``_solve_cols``)."""
    rng = np.random.default_rng(9)
    B, R, M = 4, 7, 10
    A = rng.normal(size=(B, M, M))
    K = A @ A.transpose(0, 2, 1) + M * np.eye(M)
    rhs = rng.normal(size=(B, R, M))
    LD = kkt.ldl_factor_plain(torch.as_tensor(K))
    X = kkt.ldl_solve_many(LD, torch.as_tensor(rhs))
    assert X.shape == (B, R, M)
    for r in range(R):
        np.testing.assert_array_equal(
            X[:, r].numpy(),
            kkt.ldl_solve_plain(LD, torch.as_tensor(rhs[:, r])).numpy())
    for b in range(B):
        jX = js._solve_cols(jnp.asarray(LD[b].numpy()), jnp.asarray(rhs[b]))
        _close(X[b].numpy(), np.asarray(jX), 1e-12)
    _close(np.einsum("bij,brj->bri", K, X.numpy()), rhs, 1e-10)


def test_frozen_nan_lane_stays_in_its_lane():
    """A lane whose matrix holds NaN (a frozen lane of the batch-first
    solver) poisons only its own solution."""
    tp, _, K, r = _batch(LAYOUTS[0], 3, seed=6)
    K = K.copy()
    K[1, 0, 0] = np.nan
    x = ts.solve_kkt_stage(torch.as_tensor(K), torch.as_tensor(r), tp)
    assert not torch.isfinite(x[1]).all()
    assert torch.isfinite(x[[0, 2]]).all()
    ref = ts.solve_kkt_stage(torch.as_tensor(K[[0, 2]]),
                             torch.as_tensor(r[[0, 2]]), tp)
    np.testing.assert_array_equal(x[[0, 2]].numpy(), ref.numpy())


# ---- routing ---------------------------------------------------------------

P866 = ts.build_stage_partition(96, 1, 1, 1, 2, "collocation")
P200 = ts.build_stage_partition(22, 1, 1, 1, 2, "collocation")
P92 = ts.build_stage_partition(10, 1, 1, 1, 2, "collocation")


def test_routing_rule_on_the_cpu():
    """Off the card "auto" never reaches the dense kernels: the sweep
    from stage_min_size up with a matching partition, else LU — the JAX
    package's rule off a TPU."""
    cpu = torch.device("cpu")
    assert kkt.resolve_kkt_method("auto", 866, cpu, P866) == "stage"
    assert kkt.resolve_kkt_method("auto", 200, cpu, P200) == "stage"
    assert kkt.resolve_kkt_method("auto", 92, cpu, P92) == "lu"
    assert kkt.resolve_kkt_method("auto", 866, cpu) == "lu"
    assert kkt.resolve_kkt_method("auto", 866, cpu, P200) == "lu"
    assert kkt.resolve_kkt_method("auto", 866, cpu, P866,
                                  stage_min_size=900) == "lu"
    assert kkt.resolve_kkt_method("stage", 92, cpu, P92) == "stage"
    with pytest.raises(ValueError, match="stage_partition"):
        kkt.resolve_kkt_method("stage", 866, cpu)
    with pytest.raises(ValueError, match="stage_partition"):
        kkt.resolve_kkt_method("stage", 866, cpu, P200)
    # the JAX package resolves the same way off a TPU
    for N, size, p in ((22, 200, P200), (10, 92, P92)):
        jp = js.build_stage_partition(N, 1, 1, 1, 2, "collocation")
        assert jsolver._resolve_method("auto", size, jp, 192) == \
            kkt.resolve_kkt_method("auto", size, cpu, p)


def test_routing_rule_on_cuda_is_static(monkeypatch):
    """On CUDA (card properties monkeypatched): the dense kernels where
    they fit, the stage sweep only where they do not and the system has at
    least stage_min_size rows, LU otherwise; no probe, no fallback."""
    monkeypatch.setattr(kkt, "_smem_optin", lambda dev: 232448)
    cuda = torch.device("cuda", 0)
    assert kkt.ldl_fits(92, cuda) and kkt.ldl_fits(200, cuda)
    assert not kkt.ldl_fits(866, cuda)
    assert kkt.resolve_kkt_method("auto", 92, cuda, P92) == "ldl"
    assert kkt.resolve_kkt_method("auto", 200, cuda, P200) == "ldl"
    assert kkt.resolve_kkt_method("auto", 866, cuda, P866) == "stage"
    assert kkt.resolve_kkt_method("auto", 866, cuda) == "lu"
    assert kkt.resolve_kkt_method("auto", 866, cuda, P866,
                                  stage_min_size=1000) == "lu"
    assert ts.stage_method_available(P866, cuda)
    assert not ts.stage_method_available(P866._replace(block=300), cuda)
    # a card with less opt-in shared memory: 200 no longer fits the kernels
    monkeypatch.setattr(kkt, "_smem_optin", lambda dev: 48 * 1024)
    assert kkt.resolve_kkt_method("auto", 200, cuda, P200) == "stage"


def test_attach_and_plan_worthwhile_match_jax():
    jp866 = js.build_stage_partition(96, 1, 1, 1, 2, "collocation")
    jp200 = js.build_stage_partition(22, 1, 1, 1, 2, "collocation")
    cases = [{}, {"kkt_method": "stage"}, {"kkt_method": "lu"},
             {"jacobian": "dense"}, {"jacobian": "sparse"},
             {"fused_ls_jacobian": "on"}, {"jacobian_min_size": 1000}]
    for kw in cases:
        for jp, tp in ((jp866, P866), (jp200, P200), (None, None)):
            jo = jsolver.SolverOptions(**kw)
            to = tsolver.SolverOptions(**kw)
            assert tsolver.plan_worthwhile(to, tp, "cpu") == \
                jsolver.plan_worthwhile(jo, jp), (kw, tp and tp.n_total)
            ja = jsolver.attach_stage_partition(jo, jp)
            ta = tsolver.attach_stage_partition(to, tp)
            assert (ta.stage_partition is None) == (ja.stage_partition is None)
    attached = tsolver.attach_stage_partition(tsolver.SolverOptions(), P92)
    assert attached.stage_partition == P92
    assert tsolver.attach_stage_partition(attached, P866) is attached
    assert tsolver.plan_worthwhile(None, P866, "cpu") is False


# ---- on the card -------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("kind,B,M", [
    ("factor", 256, 10), ("factor", 256, 5),
    ("solve", 2560, 10), ("solve", 256, 10), ("solve", 1280, 5),
    ("solve", 256, 5)])
def test_stage_shapes_on_card_equal_plain(cuda_device, kind, B, M):
    """Both kernels at the stage sweep's shapes, bitwise against their
    plain versions on the same card."""
    rng = np.random.default_rng(B + M)
    A = rng.normal(size=(B, M, M))
    K = torch.as_tensor(A @ A.transpose(0, 2, 1) + M * np.eye(M),
                        dtype=torch.float32, device=cuda_device)
    b = torch.as_tensor(rng.normal(size=(B, M)), dtype=torch.float32,
                        device=cuda_device)
    LD = kkt.ldl_factor_plain(K)
    if kind == "factor":
        assert torch.equal(kkt.ldl_factor(K), LD)
    else:
        assert torch.equal(kkt.ldl_solve(LD, b), kkt.ldl_solve_plain(LD, b))


@pytest.mark.cuda
def test_stage_sweep_on_card_equals_plain_sweep(cuda_device):
    """The sweep on the kernels equals the sweep on the plain versions on
    the same card, stage factors and solutions, and launches the kernels
    once per stage (factor) and per block solve."""
    tp, _, K, r = _batch(LAYOUTS[0], 8, seed=3, dtype=np.float32)
    Kc = torch.as_tensor(K, device=cuda_device)
    rc = torch.as_tensor(r, device=cuda_device)
    kkt.reset_launch_counts()
    f = ts.factor_kkt_stage(Kc, tp)
    x = ts.resolve_kkt_stage(f, rc, tp)
    S = tp.n_stages
    assert kkt.ldl_factor.launches == S
    assert kkt.ldl_solve.launches == (S - 1) + 3 * (2 * S - 1)
    assert kkt.ldl_solve_many.copied_bytes == (S - 1) * 8 * tp.block ** 3 * 4
    f_cpu = ts.factor_kkt_stage(torch.as_tensor(K), tp)
    x_cpu = ts.resolve_kkt_stage(f_cpu, torch.as_tensor(r), tp)
    np.testing.assert_allclose(f[0].cpu().numpy(), f_cpu[0].numpy(),
                               rtol=RTOL32, atol=RTOL32)
    np.testing.assert_allclose(x.cpu().numpy(), x_cpu.numpy(), rtol=RTOL32,
                               atol=RTOL32 * float(x_cpu.abs().max()))


@pytest.mark.cuda
def test_auto_resolves_to_stage_at_day_ahead_size(cuda_device):
    assert kkt.resolve_kkt_method("auto", 866, cuda_device, P866) == "stage"
    assert kkt.resolve_kkt_method("auto", 92, cuda_device, P92) == "ldl"
