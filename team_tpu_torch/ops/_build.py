"""Build the package's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/*.cu`` file exposes a plain C interface and is compiled on first
use into a shared library under ``build/team_tpu_torch/`` at the repository
root (listed in ``.gitignore``). The library's name carries a hash of the
source and the flags, so an edited source is rebuilt rather than reused.
Only the machine with the card has ``nvcc``; the CPU paths never call this.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "team_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
# ptxas's report (registers, shared memory, spills) of each build, by source name
BUILD_LOGS: Dict[str, str] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels are built "
                           "on first use on a machine with the CUDA toolkit")
    return found


def load_library(source: str) -> ctypes.CDLL:
    """Compile ``csrc/<source>`` for sm_90a (once per process and source hash)
    and return the loaded library."""
    if source in _LIBS:
        return _LIBS[source]
    src = CSRC_DIR / source
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"{src.stem}-{digest}.so"
    if not out.exists():
        # build beside the target and rename: a concurrent process never loads a torn file
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(src)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
            BUILD_LOGS[source] = proc.stdout + proc.stderr
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    lib = ctypes.CDLL(str(out))
    _LIBS[source] = lib
    return lib
