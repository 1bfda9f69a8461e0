"""ctypes binding of the native host-runtime library (port of
``ibamr_tpu/io/native.py``).

The host-side hot loops of structure-file parsing and binary VTK
encoding run in C++ (``ibamr_tpu_torch/csrc/ibamr_native.cpp``, the
port's own copy of the reference's source), bound with ``ctypes``. The
library is compiled on first use with ``g++ -O3 -shared -fPIC`` into
``ibamr_tpu_torch/csrc/build/``, named by the hash of its source and
flags, and written through a temporary file and a rename, so parallel
test workers (or the reference package, which builds into its own
``native/build/``) never write one ``.so``. Every entry point returns
``None`` when no compiler is present, and its caller then runs the
NumPy parser or the stdlib encoder: host code on either side, never a
device fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_SRC = _CSRC / "ibamr_native.cpp"
_BUILD_DIR = _CSRC / "build"
_FLAGS = ("-O3", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def lib_path() -> Path:
    """The library's path: named by the hash of its source and flags,
    so an edited source builds anew and an unchanged one loads."""
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return _BUILD_DIR / f"libibamr_native_{h.hexdigest()[:16]}.so"


def _compile(path: Path) -> Optional[Path]:
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *_FLAGS, str(_SRC), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, path)
        return path
    except (OSError, subprocess.SubprocessError):
        try:
            os.remove(tmp)
        except OSError:
            pass
        return None


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (compiling if needed) the native library; None when it is
    unavailable (callers then run their NumPy or stdlib path)."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not _SRC.exists():
            return None
        path = lib_path()
        if not path.exists() and _compile(path) is None:
            return None
        _lib = _load(path)
        if _lib is None and _compile(path) is not None:
            # a damaged library file: rebuild once and retry
            _lib = _load(path)
        return _lib


def _load(path: Path) -> Optional[ctypes.CDLL]:
    """Load + ABI-check + declare signatures; None on any mismatch."""
    try:
        lib = ctypes.CDLL(str(path))
        if lib.ibamr_native_abi_version() != 2:
            return None
        lib.parse_table.restype = ctypes.c_long
        lib.parse_table.argtypes = [
            ctypes.c_char_p, ctypes.c_long,
            ctypes.POINTER(ctypes.c_double), ctypes.c_long,
            ctypes.c_long, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_long)]
        lib.encode_base64.restype = ctypes.c_long
        lib.encode_base64.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_long,
            ctypes.c_char_p]
        return lib
    except (OSError, AttributeError):
        return None


def parse_table_native(text: bytes, max_cols: int
                       ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Parse a numeric table with the C++ tokenizer -> (rows, ncols);
    None if the native library is unavailable. ``ncols`` holds the TRUE
    per-row column counts (callers validate bounds). Raises ValueError
    on an invalid token (strict, matching the Python parser)."""
    lib = get_lib()
    if lib is None:
        return None
    max_rows = text.count(b"\n") + 1
    out = np.empty((max_rows, max_cols), dtype=np.float64)
    ncols = np.zeros(max_rows, dtype=np.int32)
    status = ctypes.c_long(0)
    n = lib.parse_table(
        text, len(text),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        max_rows, max_cols,
        ncols.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        ctypes.byref(status))
    if status.value != 0:
        raise ValueError(
            f"invalid numeric token on line {status.value}")
    return out[:n], ncols[:n]


def base64_native(data: bytes) -> Optional[bytes]:
    """RFC 4648 base64 via the C++ encoder; None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(data)
    out = ctypes.create_string_buffer(4 * ((n + 2) // 3))
    arr = (ctypes.c_uint8 * n).from_buffer_copy(data)
    m = lib.encode_base64(arr, n, out)
    return out.raw[:m]
