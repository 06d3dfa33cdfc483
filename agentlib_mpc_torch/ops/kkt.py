"""Batched KKT linear algebra: pivot-free LDLᵀ factor and solve.

Port of ``agentlib_mpc_tpu/ops/kkt.py``. The interior-point solver factors
one symmetric quasi-definite KKT matrix

    K = [[W, Jgᵀ], [Jg, -δ_c I]],   W ≻ 0 (Levenberg-regularized)

per Newton iteration for every zone of the batch. A quasi-definite matrix
admits a stable LDLᵀ for any symmetric pivot order (Vanderbei 1995), so no
pivoting is needed; Jacobi equilibration plus two steps of iterative
refinement (``resolve_kkt_ldl``) recover the last bits of accuracy in f32.

Kernels. ``ldl_factor`` and ``ldl_solve`` are the wrappers of two
hand-written CUDA kernels for Hopper (``csrc/ldl_factor.cu``,
``csrc/ldl_solve.cu``), which replace the Pallas TPU kernels
``_ldl_factor_kernel`` and ``_ldl_solve_kernel`` of the JAX package. Each
kernel is a template on its element type: a float32 and a float64 entry
point. Each wrapper runs its kernel on a CUDA tensor, in float64 for a
float64 tensor and in float32 otherwise (a narrower type is cast in and
out, as the TPU path does), so a factor is never computed in a lower
precision than its input's; or raises. It runs the plain PyTorch version
(``ldl_factor_plain``/``ldl_solve_plain``, in the input dtype) only
because the tensor it was given lies on the CPU. Each keeps a launch
counter (``ldl_factor.launches``, ``ldl_solve.launches``, both types) and
the sets of (B, M) batch shapes it launched at in float32 (``.shapes``)
and in float64 (``.shapes_f64``), updated under a lock: the real-time
ADMM module launches from its worker threads.

Many right-hand sides. ``ldl_solve_many`` solves R right-hand sides
against one factor (the stage sweep's ``C⁻¹ Eᵀ``). The kernel takes one
system per right-hand side, so on CUDA the factor is expanded to R
contiguous copies before one launch; ``ldl_solve_many.copied_bytes``
counts the bytes of those copies.

Routing. ``resolve_kkt_method("auto", size, device, partition,
stage_min_size, dtype)`` replaces the JAX package's eager availability
probes with a static rule: "auto" is ``"ldl"`` on CUDA when M <= ``MAX_M``
(240) and both kernels fit one block's opt-in shared memory
(``shared_memory_per_block_optin``) in the solve's dtype (float64 takes
twice float32's); otherwise ``"stage"`` when a stage
partition of this size is attached and M >= ``stage_min_size`` (the
block sweep of ``ops/stagewise.py``, whose blocks go through the same two
kernels on CUDA); otherwise ``"lu"``. On the CPU "auto" is never
``"ldl"``, as the JAX package resolves off a TPU.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from agentlib_mpc_torch.utils import cuda_build

_TINY = 1e-30

#: block shared memory available without opting in (CUDA's default)
_DEFAULT_SMEM = 48 * 1024


def _safe_d(d: torch.Tensor) -> torch.Tensor:
    """Clamp a pivot away from zero, preserving sign (0 counts as +)."""
    tiny = torch.full_like(d, _TINY)
    return torch.where(d >= 0, torch.maximum(d, tiny), torch.minimum(d, -tiny))


# --------------------------------------------------------------------------
# Plain versions: batch-major, a Python loop over k only
# --------------------------------------------------------------------------

def ldl_factor_plain(K: torch.Tensor) -> torch.Tensor:
    """Compact LDLᵀ of (..., M, M) symmetric quasi-definite matrices, in the
    input dtype, as ``tril(LD)``: unit L strictly below the diagonal, D on
    it, zeros above it (JAX package: ``ldl_factor_ref``, which reads row k
    where this reads column k). Reads only the lower triangle of K; works on
    a copy, updated in place step by step."""
    A = torch.tril(K)
    M = A.shape[-1]
    for k in range(M):
        d = _safe_d(A[..., k, k])
        w = A[..., k + 1:, k]
        l = w / d[..., None]
        # rank-1 update of the lower trailing triangle (i >= j > k); the
        # upper part takes a zero and stays zero
        A[..., k + 1:, k + 1:] -= torch.tril(l[..., :, None] * w[..., None, :])
        A[..., k + 1:, k] = l
    return A


def ldl_solve_plain(LD: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve L D Lᵀ x = b from a compact factor (JAX package:
    ``ldl_solve_ref``), batched over the leading axes, in the input dtype."""
    x = b.clone()
    M = LD.shape[-1]
    for k in range(M):
        x[..., k + 1:] -= LD[..., k + 1:, k] * x[..., k, None]
    x = x / _safe_d(torch.diagonal(LD, dim1=-2, dim2=-1))
    for k in range(M - 1, -1, -1):
        x[..., :k] -= LD[..., k, :k] * x[..., k, None]
    return x


# --------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------

#: C signatures of the kernels' float32 entry points (pointers and the
#: stream as c_void_p, so ctypes never truncates them to 32 bits); each
#: float64 entry point has the same signature, its name ending in _f64
_SIGNATURES = {
    "ldl_factor": ("ldl_factor_f32", [ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_int, ctypes.c_int,
                                      ctypes.c_void_p]),
    "ldl_solve": ("ldl_solve_f32", [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_void_p]),
}

#: the largest M the kernels take (``kMaxM`` in ``csrc/``), the range
#: "auto" routed here before the redesign; a lane keeps ceil(M/32) <= 8
#: rows of a column in registers
MAX_M = 240

_ENTRIES: dict = {}
_SMEM_OPTIN: dict = {}


def _entry(name: str, dtype: torch.dtype = torch.float32):
    """The C entry point of kernel ``name`` in ``dtype`` (float32 or
    float64), with argtypes declared; resolved on first use and cached."""
    key = name if dtype == torch.float32 else (name, dtype)
    fn = _ENTRIES.get(key)
    if fn is None:
        fn_name, argtypes = _SIGNATURES[name]
        if dtype == torch.float64:
            fn_name = fn_name[:-len("_f32")] + "_f64"
        fn = getattr(cuda_build.load(name), fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _ENTRIES[key] = fn
    return fn


def kernel_dtype(dtype: torch.dtype) -> torch.dtype:
    """The type a kernel computes in for inputs of ``dtype``: float64 for
    float64, float32 for every other floating type."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def factor_smem_bytes(M: int, itemsize: int = 4) -> int:
    """Shared memory one factor block needs for an M×M matrix of
    ``itemsize``-byte elements: the packed lower triangle and two
    double-buffered M-vectors (l and w); the formula of ``smem_bytes`` in
    ``csrc/ldl_factor.cu``."""
    return (M * (M + 1) // 2 + 4 * M) * itemsize


def solve_smem_bytes(M: int, itemsize: int = 4) -> int:
    """Shared memory one solve block needs for an M×M factor of
    ``itemsize``-byte elements: the packed lower triangle; the formula of
    ``smem_bytes`` in ``csrc/ldl_solve.cu``."""
    return M * (M + 1) // 2 * itemsize


def _smem_optin(device: torch.device) -> int:
    """Opt-in shared memory per block of a CUDA device, cached per device
    index."""
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    optin = _SMEM_OPTIN.get(index)
    if optin is None:
        props = torch.cuda.get_device_properties(index)
        optin = int(getattr(props, "shared_memory_per_block_optin",
                            _DEFAULT_SMEM))
        _SMEM_OPTIN[index] = optin
    return optin


def _check_cuda_input(t: torch.Tensor, name: str, ndim_min: int):
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CPU or CUDA tensor, got "
                         f"{t.device}")
    if not t.is_floating_point():
        raise TypeError(f"{name} must be floating point, got {t.dtype}")
    if t.ndim < ndim_min:
        raise ValueError(f"{name} must have at least {ndim_min} dims, got "
                         f"shape {tuple(t.shape)}")


def _check_size(M: int, device: torch.device, dtype: torch.dtype) -> None:
    if not ldl_fits(M, device, dtype):
        itemsize = torch.empty((), dtype=dtype).element_size()
        raise ValueError(
            f"an {M}x{M} LDLᵀ in {dtype} needs "
            f"{factor_smem_bytes(M, itemsize)} bytes of shared memory per "
            f"block (this card: {_smem_optin(device)}) and M <= {MAX_M}; "
            f"use kkt_method='lu' (resolve_kkt_method routes 'auto' there)")


def _as_kernel_dtype(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when it is contiguous in its kernel type
    (:func:`kernel_dtype`), else a contiguous copy in that type."""
    dtype = kernel_dtype(t.dtype)
    if t.dtype == dtype and t.is_contiguous():
        return t
    return t.to(dtype).contiguous()


def _launch(name: str, device: torch.device, dtype: torch.dtype,
            *args) -> None:
    """Call kernel ``name``'s ``dtype`` entry point with ``args`` and the
    current stream of ``device``; raise on a failed launch."""
    with torch.cuda.device(device):
        rc = _entry(name, dtype)(
            *args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


_RECORD_LOCK = threading.Lock()


def _record(wrapper, dtype: torch.dtype, shape) -> None:
    with _RECORD_LOCK:
        wrapper.launches += 1
        (wrapper.shapes_f64 if dtype == torch.float64
         else wrapper.shapes).add(shape)


def ldl_factor(K: torch.Tensor) -> torch.Tensor:
    """Compact LDLᵀ factor of (..., M, M) symmetric quasi-definite
    matrices, as ``tril(LD)``: unit L strictly below the diagonal, D on it,
    zeros above it. Reads only the lower triangle of K. CUDA: the
    ``csrc/ldl_factor.cu`` kernel in :func:`kernel_dtype`; CPU:
    ``ldl_factor_plain``."""
    if K.device.type == "cpu":
        return ldl_factor_plain(K)
    _check_cuda_input(K, "K", 2)
    M = K.shape[-1]
    if K.shape[-2] != M:
        raise ValueError(f"K must be square, got shape {tuple(K.shape)}")
    Kf = _as_kernel_dtype(K)
    out = torch.empty_like(Kf)
    B = Kf.numel() // (M * M) if M else 0
    if B:
        _check_size(M, K.device, Kf.dtype)
        _launch("ldl_factor", K.device, Kf.dtype, Kf.data_ptr(),
                out.data_ptr(), B, M)
        _record(ldl_factor, Kf.dtype, (B, M))
    return out if K.dtype == Kf.dtype else out.to(K.dtype)


ldl_factor.launches = 0
ldl_factor.shapes = set()
ldl_factor.shapes_f64 = set()


def ldl_solve(LD: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve L D Lᵀ x = b from :func:`ldl_factor` output; LD (..., M, M),
    b (..., M) with the same leading axes. Reads only the lower triangle
    of LD. CUDA: the ``csrc/ldl_solve.cu`` kernel in the kernel type of
    ``b`` (:func:`kernel_dtype`); CPU: ``ldl_solve_plain``."""
    if LD.device.type == "cpu" and b.device.type == "cpu":
        return ldl_solve_plain(LD, b)
    _check_cuda_input(LD, "LD", 2)
    _check_cuda_input(b, "b", 1)
    M = LD.shape[-1]
    if LD.device != b.device or LD.shape[-2] != M or \
            LD.shape[:-1] != b.shape:
        raise ValueError(f"LD {tuple(LD.shape)} on {LD.device} and b "
                         f"{tuple(b.shape)} on {b.device} do not match")
    bf = _as_kernel_dtype(b)
    LDf = LD if LD.dtype == bf.dtype and LD.is_contiguous() else \
        LD.to(bf.dtype).contiguous()
    out = torch.empty_like(bf)
    B = bf.numel() // M if M else 0
    if B:
        _check_size(M, b.device, bf.dtype)
        _launch("ldl_solve", b.device, bf.dtype, LDf.data_ptr(),
                bf.data_ptr(), out.data_ptr(), B, M)
        _record(ldl_solve, bf.dtype, (B, M))
    return out if b.dtype == bf.dtype else out.to(b.dtype)


ldl_solve.launches = 0
ldl_solve.shapes = set()
ldl_solve.shapes_f64 = set()


def raw_launcher(name: str, *tensors: torch.Tensor):
    """For timing only: a zero-argument callable that launches kernel
    ``name`` on the given contiguous CUDA tensors, all float32 or all
    float64 (factor: K, out; solve: LD, b, out), with the entry point,
    pointers, sizes and stream resolved once, so a launch costs one ctypes
    call. It keeps the tensors alive and does not count launches."""
    dtype = tensors[0].dtype
    for t in tensors:
        if t.device.type != "cuda" or t.dtype != dtype or \
                dtype not in (torch.float32, torch.float64) or \
                not t.is_contiguous():
            raise ValueError(f"{name}: raw launches take contiguous CUDA "
                             f"tensors, all float32 or all float64, got "
                             f"{t.dtype} on {t.device}")
    device = tensors[0].device
    M = tensors[0].shape[-1]
    _check_size(M, device, dtype)
    B = tensors[-1].numel() // (M * M if name == "ldl_factor" else M)
    fn = _entry(name, dtype)
    args = (*(t.data_ptr() for t in tensors), B, M,
            torch.cuda.current_stream(device).cuda_stream)

    def launch() -> None:
        if fn(*args) != 0:
            raise RuntimeError(f"{name} kernel launch failed")

    launch.tensors = tensors
    return launch


def ldl_solve_many(LD: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve R right-hand sides against each factor: LD (..., M, M), B
    (..., R, M) → X (..., R, M) with ``X[..., r, :] = (L D Lᵀ)⁻¹ B[..., r, :]``.
    CPU: ``ldl_solve_plain`` with the factor broadcast over R. CUDA: the
    factor is expanded to (..., R, M, M) and made contiguous (the solve
    kernel takes one system per right-hand side; the copy's bytes add to
    ``ldl_solve_many.copied_bytes``), then one ``ldl_solve`` launch."""
    if LD.device.type == "cpu" and B.device.type == "cpu":
        return ldl_solve_plain(LD.unsqueeze(-3), B)
    _check_cuda_input(LD, "LD", 2)
    R = B.shape[-2]
    LDx = LD.to(kernel_dtype(B.dtype)).unsqueeze(-3).expand(
        LD.shape[:-2] + (R,) + LD.shape[-2:]).contiguous()
    ldl_solve_many.copied_bytes += LDx.numel() * LDx.element_size()
    return ldl_solve(LDx, B)


ldl_solve_many.copied_bytes = 0


def reset_launch_counts() -> None:
    ldl_factor.launches = 0
    ldl_solve.launches = 0
    ldl_factor.shapes = set()
    ldl_solve.shapes = set()
    ldl_factor.shapes_f64 = set()
    ldl_solve.shapes_f64 = set()
    ldl_solve_many.copied_bytes = 0


# --------------------------------------------------------------------------
# Equilibrated factor + refined resolve
# --------------------------------------------------------------------------

def equilibrate(K: torch.Tensor):
    """Symmetric Jacobi scaling: keeps a quasi-definite matrix
    quasi-definite."""
    scale = 1.0 / torch.sqrt(torch.clamp_min(K.abs().amax(dim=-1), 1e-12))
    return K * scale[..., :, None] * scale[..., None, :], scale


def factor_kkt_ldl(K: torch.Tensor):
    """Equilibrate + factor once; returns an opaque factor for
    :func:`resolve_kkt_ldl` (predictor and corrector re-solve with new
    right-hand sides)."""
    Ks, scale = equilibrate(K)
    return (ldl_factor(Ks), Ks, scale)


def resolve_kkt_ldl(factor, rhs: torch.Tensor,
                    refine_steps: int = 2) -> torch.Tensor:
    """Solve with a stored factor + iterative refinement (f32-safe). The
    refinement product is a true-f32 matmul (the solver runs with TF32
    off)."""
    LD, Ks, scale = factor
    rs = rhs * scale
    x = ldl_solve(LD, rs)
    for _ in range(refine_steps):
        r = rs - torch.matmul(Ks, x[..., None])[..., 0]
        x = x + ldl_solve(LD, r)
    return x * scale


def solve_kkt_ldl(K: torch.Tensor, rhs: torch.Tensor,
                  refine_steps: int = 2) -> torch.Tensor:
    """Equilibrated LDLᵀ solve with iterative refinement (f32-safe)."""
    return resolve_kkt_ldl(factor_kkt_ldl(K), rhs, refine_steps)


def ldl_fits(size: int, device, dtype: torch.dtype = torch.float32) -> bool:
    """Whether the LDLᵀ kernels take a ``size``×``size`` system of
    ``dtype`` on ``device``: a CUDA device, ``size <= MAX_M``, and both
    kernels' shared memory in the kernel type of ``dtype``
    (``factor_smem_bytes``, ``solve_smem_bytes``) within the device's
    opt-in per block. Never True on the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda" or size > MAX_M:
        return False
    itemsize = 8 if kernel_dtype(dtype) == torch.float64 else 4
    return max(factor_smem_bytes(size, itemsize),
               solve_smem_bytes(size, itemsize)) <= _smem_optin(dev)


def resolve_kkt_method(method: str, size: int, device, partition=None,
                       stage_min_size: int = 192,
                       dtype: torch.dtype = torch.float32) -> str:
    """Resolve ``SolverOptions.kkt_method`` for a ``size``-dim KKT system of
    ``dtype`` on ``device``, statically (no probe, no fallback):

    - "auto" → "ldl" on CUDA when :func:`ldl_fits` (in ``dtype``: the
      kernels factor a float64 system in float64); else "stage" when
      ``partition`` covers exactly ``size`` and ``size >= stage_min_size``;
      else "lu";
    - "stage" → "stage", and a ``ValueError`` without a matching
      partition;
    - "ldl" and "lu" stand as given; forcing "ldl" on the CPU runs the
      plain versions."""
    matches = partition is not None and partition.n_total == size
    if method == "auto":
        if ldl_fits(size, device, dtype):
            return "ldl"
        if matches and size >= stage_min_size:
            return "stage"
        return "lu"
    if method == "stage":
        if not matches:
            raise ValueError(
                f"kkt_method='stage' requires a stage_partition matching "
                f"the {size}-dim KKT system (got "
                f"{None if partition is None else partition.n_total}); "
                f"attach TranscribedOCP.stage_partition with "
                f"solver.attach_stage_partition")
        return "stage"
    if method in ("ldl", "lu"):
        return method
    raise ValueError(f"kkt_method must be 'auto', 'ldl', 'lu' or 'stage', "
                     f"got {method!r}")
