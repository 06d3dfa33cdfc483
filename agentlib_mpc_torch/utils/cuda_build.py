"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` into its own shared library with a
plain C interface and loaded with ``ctypes`` — no PyTorch headers, so a
build takes seconds. Libraries are named by a hash of their source, the
shared headers (``csrc/*.cuh``) and the flags (a stale library is never
loaded) and land in
``agentlib_mpc_torch/_build/``, which git ignores. All sources compile in
parallel, one ``nvcc`` process each, at the first kernel launch or when a
caller asks (``build_all``). Nothing is built at import.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}


@dataclasses.dataclass(frozen=True)
class BuildResult:
    name: str
    path: Path
    seconds: float
    cached: bool
    #: ``-Xptxas -v`` report (registers, shared memory, spills); empty when
    #: the library came from an earlier build
    ptxas: str


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, ``/usr/local/cuda/bin/nvcc`` or ``nvcc`` on
    ``PATH``; raises when none exists."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found ($CUDA_HOME/bin, /usr/local/cuda/bin, PATH): the "
            "CUDA kernels of agentlib_mpc_torch cannot be built")
    return found


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _lib_path(src: Path) -> Path:
    """The library of ``src``, named by a hash of the source, the headers
    beside it (``csrc/*.cuh``) and the flags."""
    digest = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{digest.hexdigest()[:16]}.so"


def build_all() -> dict[str, BuildResult]:
    """Compile every ``csrc/*.cu`` not yet built, all ``nvcc`` processes
    started together; returns one :class:`BuildResult` per source."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    results: dict[str, BuildResult] = {}
    running = []
    nvcc = None
    for src in sources():
        out = _lib_path(src)
        if out.is_file():
            results[src.stem] = BuildResult(src.stem, out, 0.0, True, "")
            continue
        nvcc = nvcc or find_nvcc()
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((src, out, tmp, proc, time.perf_counter()))
    for src, out, tmp, proc, t0 in running:
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n{log}")
        os.replace(tmp, out)  # atomic: a half-written library never loads
        results[src.stem] = BuildResult(src.stem, out, seconds, False, log)
    return results


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (building all sources
    first if it is missing)."""
    if name not in _LIBS:
        src = CSRC_DIR / f"{name}.cu"
        if not src.is_file():
            raise FileNotFoundError(src)
        path = _lib_path(src)
        if not path.is_file():
            build_all()
        _LIBS[name] = ctypes.CDLL(str(path))
    return _LIBS[name]
