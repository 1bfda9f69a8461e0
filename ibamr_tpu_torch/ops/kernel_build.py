"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source compiles with its own ``nvcc`` process into a
shared library with a plain C interface, loaded with ``ctypes``. All
missing libraries build in parallel at first use; a library is named by
the hash of its sources and flags, so an edited source rebuilds and an
unchanged one loads from ``csrc/build/``. Nothing builds at import time:
the CPU tests import every module and have no compiler.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
SOURCES = {"packed_spread": "packed_spread.cu",
           "packed_interp": "packed_interp.cu",
           "tile_spread": "tile_spread.cu",
           "tile_interp": "tile_interp.cu"}
HEADERS = ("delta.cuh", "spread_column.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# what the last build reported: seconds and each source's ptxas summary
build_report: Dict[str, object] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found (PATH, CUDA_HOME): the CUDA kernels build "
            "only on a machine with the CUDA toolkit")
    return str(path)


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (SOURCES[name],) + HEADERS:
        h.update((CSRC / f).read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def load_all() -> Dict[str, ctypes.CDLL]:
    """Build every missing kernel library (one nvcc each, started
    together) and load them all. Raises with the compiler's output if a
    build fails."""
    with _lock:
        if len(_libs) == len(SOURCES):
            return dict(_libs)
        t0 = time.perf_counter()
        jobs = {}
        for name, src in SOURCES.items():
            path = _lib_path(name)
            if path.exists():
                continue
            nvcc = _nvcc()
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
            jobs[name] = (path, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        failed = []
        ptxas = {}
        for name, (path, tmp, proc) in jobs.items():
            log, _ = proc.communicate()
            ptxas[name] = "\n".join(ln for ln in log.splitlines()
                                    if "ptxas info" in ln)
            if proc.returncode != 0:
                failed.append(f"{SOURCES[name]}:\n{log}")
                continue
            os.replace(tmp, path)
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n"
                               + "\n".join(failed))
        build_report.update(seconds=time.perf_counter() - t0,
                            built=sorted(jobs), ptxas=ptxas)
        for name in SOURCES:
            _libs[name] = ctypes.CDLL(str(_lib_path(name)))
        return dict(_libs)
