"""Build the package's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/*.cu`` file exposes a plain C interface and is compiled on first
use into a shared library under ``build/team_tpu_torch/`` at the repository
root (listed in ``.gitignore``). The library's name carries a hash of the
source, the shared ``csrc/*.cuh`` headers and the flags, so an edited source
is rebuilt rather than reused.
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
from typing import Dict, Iterable

from team_tpu_torch.utils import phase_timer

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


def _target(source: str) -> Path:
    src = CSRC_DIR / source
    # the shared headers count too: a source that includes an edited one is rebuilt
    headers = b"".join(p.read_bytes() for p in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{digest}.so"


def _compile(sources: Iterable[str]) -> None:
    """Compile the sources whose library is not built yet, one ``nvcc`` each,
    all started together; wait for every one of them (in one
    ``kernels.build`` span; the ``kernels.built`` counter counts the sources)."""
    todo = [(source, _target(source)) for source in dict.fromkeys(sources)
            if source not in _LIBS]
    todo = [(source, out) for source, out in todo if not out.exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    phase_timer.count(phase_timer.KERNELS_BUILT, len(todo))
    with phase_timer.phase(phase_timer.KERNELS_BUILD):
        _run_nvcc(todo)


def _run_nvcc(todo) -> None:
    jobs = []
    try:
        for source, out in todo:
            # build beside the target and rename: a concurrent process never loads a torn file
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            jobs.append((source, out, tmp, subprocess.Popen(
                [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / source)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = []
        for source, out, tmp, proc in jobs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed on {source}:\n{log}")
                continue
            BUILD_LOGS[source] = log
            os.replace(tmp, out)
        if failed:
            raise RuntimeError("\n".join(failed))
    finally:
        for _, _, tmp, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.remove(tmp)


def load_library(source: str) -> ctypes.CDLL:
    """Compile ``csrc/<source>`` for sm_90a (once per process and source hash)
    and return the loaded library."""
    if source not in _LIBS:
        _compile([source])
        _LIBS[source] = ctypes.CDLL(str(_target(source)))
    return _LIBS[source]


def build_all(sources: Iterable[str]) -> None:
    """Compile several sources in parallel and load them (set-up)."""
    sources = list(sources)
    _compile(sources)
    for source in sources:
        load_library(source)
