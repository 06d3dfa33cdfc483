"""The port's LDLᵀ KKT algebra (``agentlib_mpc_torch/ops/kkt.py``) against
the JAX package's (``agentlib_mpc_tpu/ops/kkt.py``).

The plain PyTorch versions are held against the pure-JAX reference in f64
and against the Pallas TPU kernels run through the Pallas interpreter in
f32 (the ``tests/test_kkt.py`` pattern). The CUDA kernels are held against
the plain versions on a card; those tests carry the ``cuda`` marker and
skip without one.
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agentlib_mpc_tpu.ops import kkt as jkkt
from agentlib_mpc_torch.ops import kkt
from agentlib_mpc_torch.ops import solver as tsolver

from _torch_threads import one_torch_thread  # noqa: F401


def _quasi_definite_batch(B, n, m, seed=0):
    """Random interior-point-shaped KKT matrices [[W, Jgᵀ], [Jg, -δI]]
    and right-hand sides, float64 numpy (tests/test_kkt.py construction)."""
    rng = np.random.default_rng(seed)
    Ks, rhss = [], []
    for _ in range(B):
        A = rng.normal(size=(n, n))
        W = A @ A.T + 3 * np.eye(n)
        Jg = rng.normal(size=(m, n))
        Ks.append(np.block([[W, Jg.T], [Jg, -1e-6 * np.eye(m)]]))
        rhss.append(rng.normal(size=n + m))
    return np.stack(Ks), np.stack(rhss)


def _residual(K, x, rhs):
    return float(np.max(np.abs(np.einsum("...ij,...j->...i", K, x) - rhs)))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def test_plain_matches_jax_reference_f64():
    """Same recursion: f64 agreement to round-off (1e-12 relative to the
    entries' scale) on the lower triangle, the factor's contract (the JAX
    reference leaves junk above the diagonal, the port zeros)."""
    K, rhs = _quasi_definite_batch(6, 11, 4, seed=1)
    LD_ref = np.array(jax.vmap(jkkt.ldl_factor_ref)(jnp.asarray(K)))
    x_ref = np.asarray(jax.vmap(jkkt.ldl_solve_ref)(jnp.asarray(LD_ref),
                                                   jnp.asarray(rhs)))
    LD = kkt.ldl_factor_plain(torch.as_tensor(K)).numpy()
    x = kkt.ldl_solve_plain(torch.as_tensor(LD_ref),
                            torch.as_tensor(rhs)).numpy()
    np.testing.assert_allclose(LD, np.tril(LD_ref), rtol=1e-12,
                               atol=1e-12 * np.abs(LD_ref).max())
    np.testing.assert_allclose(x, x_ref, rtol=1e-12,
                               atol=1e-12 * np.abs(x_ref).max())
    assert _residual(K, x, rhs) < 1e-8


_CASES = pytest.mark.parametrize(
    "B,n,m", [(5, 13, 5), (3, 7, 3), (256, 61, 31)],
    ids=["5x18", "pad-3x10", "main-256x92"])


@_CASES
def test_plain_factor_is_tril_of_jax_reference_f64(B, n, m):
    """The plain factor is ``tril(LD)``: exact zeros above the diagonal,
    and on and below it the JAX reference's factor to 1e-12 in f64 (the
    reference reads row k where the port reads column k; the matrices are
    symmetric only to round-off)."""
    K, _ = _quasi_definite_batch(B, n, m, seed=B + 1)
    LD_ref = np.array(jax.vmap(jkkt.ldl_factor_ref)(jnp.asarray(K)))
    LD = kkt.ldl_factor_plain(torch.as_tensor(K)).numpy()
    assert np.all(np.triu(LD, 1) == 0.0)
    np.testing.assert_allclose(LD, np.tril(LD_ref), rtol=1e-12,
                               atol=1e-12 * np.abs(LD_ref).max())


def test_plain_factor_reads_only_the_lower_triangle():
    """What lies above the diagonal of K never reaches the factor."""
    K, _ = _quasi_definite_batch(4, 9, 4, seed=7)
    Kt = torch.as_tensor(K)
    junk = Kt + torch.triu(torch.full_like(Kt, 1e3), 1)
    assert torch.equal(kkt.ldl_factor_plain(junk),
                       kkt.ldl_factor_plain(Kt))


@_CASES
def test_plain_matches_pallas_interpret_f32(B, n, m):
    """The TPU kernels through the Pallas interpreter vs the plain versions,
    both in f32: the lower triangle (the factor's contract; the plain
    factor holds zeros above it) and the solution agree to f32 round-off
    accumulated over the recursion (rtol 1e-4, atol 1e-5 as in
    tests/test_kkt.py; the TPU solve multiplies by a precomputed 1/d where
    the plain version divides)."""
    K, rhs = _quasi_definite_batch(B, n, m, seed=B)
    Kj = jnp.asarray(K, jnp.float32)
    LD_tpu = np.array(jkkt._ldl_factor_batched(Kj, interpret=True))
    x_tpu = np.asarray(jkkt._ldl_solve_batched(
        jnp.asarray(LD_tpu), jnp.asarray(rhs, jnp.float32), interpret=True))
    K32 = torch.as_tensor(K, dtype=torch.float32)
    LD = kkt.ldl_factor_plain(K32)
    assert np.all(np.triu(LD.numpy(), 1) == 0.0)
    x = kkt.ldl_solve_plain(torch.as_tensor(LD_tpu),
                            torch.as_tensor(rhs, dtype=torch.float32))
    np.testing.assert_allclose(LD.numpy(), np.tril(LD_tpu),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(x.numpy(), x_tpu, rtol=1e-4,
                               atol=1e-4 * np.abs(x_tpu).max())
    x_own = kkt.ldl_solve_plain(LD, torch.as_tensor(rhs, dtype=torch.float32))
    assert _residual(K, x_own.numpy().astype(np.float64), rhs) < 1e-2


def test_solve_kkt_ldl_refinement_accuracy_f32():
    """Equilibration + two refinement steps bring the f32 solve to the
    residual tests/test_kkt.py demands of the JAX path (1e-4)."""
    K, rhs = _quasi_definite_batch(4, 17, 6, seed=2)
    x = kkt.solve_kkt_ldl(torch.as_tensor(K, dtype=torch.float32),
                          torch.as_tensor(rhs, dtype=torch.float32))
    assert _residual(K.astype(np.float32), x.numpy(),
                     rhs.astype(np.float32)) < 1e-4
    x_jax = np.asarray(jax.vmap(jkkt.solve_kkt_ldl)(
        jnp.asarray(K, jnp.float32), jnp.asarray(rhs, jnp.float32)))
    np.testing.assert_allclose(x.numpy(), x_jax, rtol=1e-4, atol=1e-5)


def test_indefinite_matrix_same_pattern_as_jax():
    """A genuinely indefinite matrix (zero pivot) gives the same finite /
    non-finite pattern as the JAX reference — never a silent difference."""
    K = np.diag([1.0, -1.0, 0.0, 2.0])
    rhs = np.ones(4)
    x_ref = np.asarray(jkkt.ldl_solve_ref(
        jkkt.ldl_factor_ref(jnp.asarray(K, jnp.float32)),
        jnp.asarray(rhs, jnp.float32)))
    x = kkt.ldl_solve_plain(
        kkt.ldl_factor_plain(torch.as_tensor(K, dtype=torch.float32)),
        torch.as_tensor(rhs, dtype=torch.float32)).numpy()
    assert x.shape == (4,)
    np.testing.assert_array_equal(np.isfinite(x), np.isfinite(x_ref))
    fin = np.isfinite(x_ref)
    np.testing.assert_allclose(x[fin], x_ref[fin], rtol=1e-6)


def test_wrappers_run_plain_on_cpu_without_launching():
    K, rhs = _quasi_definite_batch(3, 5, 2, seed=3)
    Kt = torch.as_tensor(K)
    before = (kkt.ldl_factor.launches, kkt.ldl_solve.launches)
    LD = kkt.ldl_factor(Kt)
    x = kkt.ldl_solve(LD, torch.as_tensor(rhs))
    assert (kkt.ldl_factor.launches, kkt.ldl_solve.launches) == before
    assert LD.dtype == torch.float64  # the CPU path keeps the input dtype
    np.testing.assert_array_equal(LD.numpy(),
                                  kkt.ldl_factor_plain(Kt).numpy())
    assert _residual(K, x.numpy(), rhs) < 1e-8


def test_auto_routing_rule_on_cpu():
    """Off the card "auto" is LU below stage_min_size (as the JAX package
    resolves off a TPU); forcing "ldl" stands; "stage" needs a matching
    stage partition and raises without one."""
    from agentlib_mpc_torch.ops.stagewise import build_stage_partition

    assert kkt.resolve_kkt_method("auto", 92, "cpu") == "lu"
    assert kkt.resolve_kkt_method("ldl", 92, "cpu") == "ldl"
    assert kkt.resolve_kkt_method("lu", 92, "cpu") == "lu"
    assert not kkt.ldl_fits(92, "cpu")
    with pytest.raises(ValueError, match="stage_partition"):
        kkt.resolve_kkt_method("stage", 92, "cpu")
    part = build_stage_partition(10, 1, 1, 1, 2, "collocation")
    assert kkt.resolve_kkt_method("stage", 92, "cpu", part) == "stage"
    assert kkt.resolve_kkt_method("auto", 92, "cpu", part) == "lu"
    with pytest.raises(ValueError):
        kkt.resolve_kkt_method("cholesky", 92, "cpu")


def test_library_name_follows_shared_headers(monkeypatch, tmp_path):
    """A kernel's library is named by a hash that covers the headers its
    source includes, so an edited header never loads a stale library."""
    from agentlib_mpc_torch.utils import cuda_build

    monkeypatch.setattr(cuda_build, "CSRC_DIR", tmp_path)
    src = tmp_path / "k.cu"
    src.write_text('#include "common.cuh"\n')
    header = tmp_path / "common.cuh"
    header.write_text("// one\n")
    before = cuda_build._lib_path(src)
    assert before == cuda_build._lib_path(src)
    header.write_text("// two\n")
    assert cuda_build._lib_path(src) != before
    assert cuda_build.sources() == [src]


#: (M, factor bytes, solve bytes): the packed lower triangle, M(M+1)/2
#: floats, for both; the factor adds two double-buffered M-vectors
_SMEM = [(7, 224, 112), (92, 18584, 17112), (128, 35072, 33024),
         (240, 119520, 115680)]


@pytest.mark.parametrize("M,factor,solve", _SMEM,
                         ids=[str(M) for M, _, _ in _SMEM])
def test_factor_smem_bytes(M, factor, solve):
    assert kkt.factor_smem_bytes(M) == (M * (M + 1) // 2 + 4 * M) * 4 \
        == factor


@pytest.mark.parametrize("M,factor,solve", _SMEM,
                         ids=[str(M) for M, _, _ in _SMEM])
def test_solve_smem_bytes(M, factor, solve):
    assert kkt.solve_smem_bytes(M) == M * (M + 1) // 2 * 4 == solve


def test_ldl_fits_boundary(monkeypatch):
    """On a card with Hopper's 232,448 B opt-in, "auto" takes LDLᵀ up to
    M = 240 (the kernels' MAX_M) and LU above; with only CUDA's default
    48 KB the factor's shared memory sets the boundary (M = 152)."""
    monkeypatch.setattr(kkt, "_smem_optin", lambda device: 232448)
    assert kkt.MAX_M == 240
    assert kkt.factor_smem_bytes(240) <= 232448
    assert kkt.ldl_fits(240, "cuda")
    assert not kkt.ldl_fits(241, "cuda")
    assert kkt.resolve_kkt_method("auto", 240, "cuda") == "ldl"
    assert kkt.resolve_kkt_method("auto", 241, "cuda") == "lu"
    monkeypatch.setattr(kkt, "_smem_optin", lambda device: 48 * 1024)
    assert kkt.ldl_fits(152, "cuda")
    assert not kkt.ldl_fits(153, "cuda")
    assert not kkt.ldl_fits(92, "cpu")


def test_float64_routing_takes_the_float64_kernels(monkeypatch):
    """A float64 system routes "auto" to the kernels only where they fit in
    float64 (twice float32's shared memory: M <= 236 with Hopper's opt-in),
    since they factor float64 in float64; float16/bfloat16 run the float32
    kernels; the CPU never routes to them."""
    monkeypatch.setattr(kkt, "_smem_optin", lambda device: 232448)
    f64 = torch.float64
    assert kkt.factor_smem_bytes(74, 8) == 2 * kkt.factor_smem_bytes(74)
    assert kkt.solve_smem_bytes(74, 8) == 2 * kkt.solve_smem_bytes(74)
    assert kkt.kernel_dtype(f64) == f64
    assert kkt.kernel_dtype(torch.float16) == torch.float32
    assert kkt.kernel_dtype(torch.bfloat16) == torch.float32
    assert kkt.ldl_fits(236, "cuda", f64)
    assert not kkt.ldl_fits(237, "cuda", f64)
    assert kkt.ldl_fits(240, "cuda", torch.float32)
    assert kkt.resolve_kkt_method("auto", 74, "cuda", dtype=f64) == "ldl"
    assert kkt.resolve_kkt_method("auto", 240, "cuda", dtype=f64) == "lu"
    assert kkt.resolve_kkt_method("auto", 74, "cpu", dtype=f64) == "lu"
    assert tsolver._resolve_paths(tsolver.SolverOptions(), 137, "cuda",
                                  f64)[1] == "ldl"
    assert tsolver._resolve_paths(tsolver.SolverOptions(), 238, "cuda",
                                  f64)[1] == "lu"


def test_float64_entry_points_named_per_type(monkeypatch):
    """A float64 launch resolves the _f64 entry point of the same library,
    cached apart from the float32 one."""
    loads = []

    class _Lib:
        def __init__(self, name):
            base = kkt._SIGNATURES[name][0][:-len("_f32")]
            for suffix in ("_f32", "_f64"):
                setattr(self, base + suffix,
                        type("Fn", (), {"__call__": lambda *a: 0})())

    def fake_load(name):
        loads.append(name)
        return _Lib(name)

    monkeypatch.setattr(kkt.cuda_build, "load", fake_load)
    monkeypatch.setattr(kkt, "_ENTRIES", {})
    f32 = kkt._entry("ldl_solve")
    f64 = kkt._entry("ldl_solve", torch.float64)
    assert f32 is not f64
    assert f64 is kkt._entry("ldl_solve", torch.float64)
    assert loads == ["ldl_solve", "ldl_solve"]


def test_entry_points_resolved_once(monkeypatch):
    """Each kernel's C entry point is looked up, and its argtypes set, on
    first use only; later launches reuse it."""
    loads = []

    class _Lib:
        def __init__(self, name):
            def fn(*args):
                return 0
            setattr(self, kkt._SIGNATURES[name][0], fn)

    def fake_load(name):
        loads.append(name)
        return _Lib(name)

    monkeypatch.setattr(kkt.cuda_build, "load", fake_load)
    monkeypatch.setattr(kkt, "_ENTRIES", {})
    for _ in range(3):
        f = kkt._entry("ldl_factor")
        s = kkt._entry("ldl_solve")
    assert loads == ["ldl_factor", "ldl_solve"]
    assert f is kkt._entry("ldl_factor") and s is kkt._entry("ldl_solve")
    assert f.argtypes == kkt._SIGNATURES["ldl_factor"][1]
    assert s.restype is ctypes.c_int


@pytest.mark.cuda
def test_auto_routing_rule_on_cuda(cuda_device):
    """On the card "auto" is the LDLᵀ kernel up to M = 240, where both
    kernels fit a block's opt-in shared memory (227 KB on Hopper), else
    LU."""
    assert kkt.resolve_kkt_method("auto", 92, cuda_device) == "ldl"
    assert kkt.resolve_kkt_method("auto", 128, cuda_device) == "ldl"
    assert kkt.resolve_kkt_method("auto", 240, cuda_device) == "ldl"
    assert kkt.resolve_kkt_method("auto", 241, cuda_device) == "lu"
    assert kkt.resolve_kkt_method("auto", 400, cuda_device) == "lu"


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,m", [(256, 61, 31), (3, 5, 2), (130, 9, 4),
                                   (64, 86, 42), (16, 160, 80)],
                         ids=["main-256x92", "3x7", "130x13", "smem-64x128",
                              "max-16x240"])
def test_cuda_kernels_match_plain(cuda_device, B, n, m):
    """Kernel vs plain version on the card, same f32 inputs: the kernels
    perform the plain versions' rounded operations in the same per-element
    order, so they agree exactly (max abs err 0.0), zeros above the
    factor's diagonal included. M = 240 is the largest "auto" routes to
    LDLᵀ."""
    K, rhs = _quasi_definite_batch(B, n, m, seed=B)
    Kc = torch.as_tensor(K, dtype=torch.float32, device=cuda_device)
    bc = torch.as_tensor(rhs, dtype=torch.float32, device=cuda_device)
    launches = kkt.ldl_factor.launches
    LD = kkt.ldl_factor(Kc)
    assert kkt.ldl_factor.launches == launches + 1
    LD_plain = kkt.ldl_factor_plain(Kc)
    assert float((LD - LD_plain).abs().max()) == 0.0
    x = kkt.ldl_solve(LD_plain, bc)
    x_plain = kkt.ldl_solve_plain(LD_plain, bc)
    assert float((x - x_plain).abs().max()) == 0.0
    x_full = kkt.solve_kkt_ldl(Kc, bc)
    resid = (torch.einsum("bij,bj->bi", Kc, x_full) - bc).abs().max()
    assert float(resid / bc.abs().max()) < 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,m", [(1, 49, 25), (1, 91, 46), (3, 5, 2)],
                         ids=["linear-qp-1x74", "one-room-1x137", "3x7"])
def test_cuda_float64_kernels_match_plain(cuda_device, B, n, m):
    """The float64 kernels against the plain versions on the card, same f64
    inputs: bitwise, as in float32, and counted as float64 launches."""
    K, rhs = _quasi_definite_batch(B, n, m, seed=B + n)
    Kc = torch.as_tensor(K, dtype=torch.float64, device=cuda_device)
    bc = torch.as_tensor(rhs, dtype=torch.float64, device=cuda_device)
    kkt.reset_launch_counts()
    LD = kkt.ldl_factor(Kc)
    x = kkt.ldl_solve(LD, bc)
    assert LD.dtype == x.dtype == torch.float64
    assert kkt.ldl_factor.shapes_f64 == kkt.ldl_solve.shapes_f64 == \
        {(B, n + m)}
    assert not kkt.ldl_factor.shapes and not kkt.ldl_solve.shapes
    LD_plain = kkt.ldl_factor_plain(Kc)
    assert float((LD - LD_plain).abs().max()) == 0.0
    assert float((x - kkt.ldl_solve_plain(LD_plain, bc)).abs().max()) == 0.0


@pytest.mark.cuda
def test_cuda_wrappers_check_inputs(cuda_device):
    """f64 inputs run the float64 kernels and come back f64; non-float and
    mismatched inputs raise instead of launching."""
    K, rhs = _quasi_definite_batch(2, 5, 2, seed=5)
    Kc = torch.as_tensor(K, device=cuda_device)
    LD = kkt.ldl_factor(Kc)
    assert LD.dtype == torch.float64
    with pytest.raises(TypeError):
        kkt.ldl_factor(Kc.to(torch.int32))
    with pytest.raises(ValueError):
        kkt.ldl_factor(Kc[..., :-1])
    with pytest.raises(ValueError):
        kkt.ldl_solve(LD, torch.as_tensor(rhs[:, :-1], device=cuda_device))
