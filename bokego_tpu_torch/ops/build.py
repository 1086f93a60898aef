"""Build the CUDA kernels with nvcc and load them with ctypes.

Every ``ops/csrc/*.cu`` becomes ``_build/lib<name>.so`` (the build directory
is git-ignored) with a plain C interface: no PyTorch headers, so a build
takes seconds.  One nvcc process per source, all started together.  A
library is rebuilt when its source is newer.  A failed build raises: nothing
falls back to the plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    "-fmad=false",  # no FMA contraction: scores round as in the JAX kernel
    "-shared", "-Xcompiler", "-fPIC",
]

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the toolkit is")
    return path


def _lib_path(src: Path) -> Path:
    return BUILD_DIR / f"lib{src.stem}.so"


def build_all(force: bool = False, verbose: bool = False) -> dict[str, str]:
    """Compile every stale source in parallel; return nvcc's output by name."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    extra = ["-Xptxas", "-v"] if verbose else []
    procs = {}
    for src in sorted(CSRC.glob("*.cu")):
        out = _lib_path(src)
        if force or not out.exists() or out.stat().st_mtime < src.stat().st_mtime:
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, *extra, "-o", str(tmp), str(src)]
            procs[src.stem] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ), tmp, out)
    logs = {}
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        os.replace(tmp, out)
        logs[name] = log
    return logs


def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu`` (building it at first use)."""
    if name not in _libs:
        build_all()
        _libs[name] = ctypes.CDLL(str(_lib_path(CSRC / f"{name}.cu")))
    return _libs[name]

