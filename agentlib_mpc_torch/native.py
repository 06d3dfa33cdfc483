"""Build and load the port's host C++ (``csrc/*.cpp``) through ctypes.

Port of ``agentlib_mpc_tpu/native/__init__.py``: each source is compiled
by ``g++`` at its first use into a shared library named by a hash of the
source and the flags, in ``agentlib_mpc_torch/_build/`` (which git
ignores) beside the CUDA kernels' libraries. The build writes a temporary
file and renames it, so concurrent processes never load a half-written
library. Unlike the JAX package's loader, nothing falls back: a failed
build or load raises, and the caller never switches to a Python version
on its own. Nothing is built at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

from agentlib_mpc_torch.utils.cuda_build import BUILD_DIR, CSRC_DIR

CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_LIBS: dict[str, ctypes.CDLL] = {}


def lib_path(name: str) -> Path:
    """The library of ``csrc/<name>.cpp``, named by a hash of the source
    and the flags."""
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cpp").read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cpp`` unless its library exists; raises when
    ``g++`` is missing or fails."""
    out = lib_path(name)
    if out.is_file():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(
            f"g++ not found on PATH: the host C++ of agentlib_mpc_torch "
            f"({name}.cpp) cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    try:
        proc = subprocess.run(
            [cxx, *CXX_FLAGS, str(CSRC_DIR / f"{name}.cpp"), "-o", tmp],
            capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(
                f"g++ failed on {name}.cpp:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)  # atomic: a half-written library never loads
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cpp``, built first if needed."""
    if name not in _LIBS:
        _LIBS[name] = ctypes.CDLL(str(build(name)))
    return _LIBS[name]
