"""ctypes bindings for the native IO library (``rcvpose_io.cpp``), the
port's own copy of ``rcvpose_tpu.native``.

The library is compiled with ``g++`` at first use into the library
directory (the git-ignored ``rcvpose_tpu_torch/_build/`` unless
``set_build_dir`` moves it), never next to the source: the file name
carries a hash of the source and the flags, and each build writes a
per-process temporary file that then replaces the target, so concurrent
processes (test workers) never load half a library. Without a toolchain
every entry point falls back to the numpy reader, as the JAX package's
does; ``available()`` says which one runs, and the loader prints it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "rcvpose_io.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
_lock = threading.Lock()
_loaded_from = {}   # library stem -> its directory
_lib = None
_tried = False
_error = None


def library_path(src=_SRC):
    """Where the library built from ``src`` (default ``rcvpose_io.cpp``)
    lives: ``<library directory>/lib<stem>_<hash of source and
    flags>.so``."""
    key = hashlib.sha256(src.read_bytes()
                         + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{src.stem}_{key}.so"


def build_library(src=_SRC):
    """Build ``src`` with ``g++`` unless its library exists; returns the
    library's path. Raises ``OSError`` or ``CalledProcessError``."""
    out = library_path(src)
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        subprocess.run(["g++", *GXX_FLAGS, str(src), "-o", str(tmp)],
                       check=True, capture_output=True)
        os.replace(tmp, out)
    return out


def load_library(src=_SRC):
    """Build ``src`` unless built and load it (``ctypes.CDLL``)."""
    lib = ctypes.CDLL(str(build_library(src)))
    _loaded_from[src.stem] = BUILD_DIR.resolve()
    return lib


def loaded_elsewhere(path):
    """Stems of the libraries loaded from a directory other than
    ``path``."""
    path = Path(path).resolve()
    return sorted(n for n, d in _loaded_from.items() if d != path)


def set_build_dir(path):
    """Build and load the libraries in ``path`` from now on (made if
    missing); ``utils.enable_compile_cache`` calls it."""
    global BUILD_DIR
    path = Path(path).resolve()
    path.mkdir(parents=True, exist_ok=True)
    BUILD_DIR = path


def _load():
    global _lib, _tried, _error
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            lib = load_library()
            lib.read_dpt.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint16),
                ctypes.c_int64, ctypes.POINTER(ctypes.c_uint32),
                ctypes.POINTER(ctypes.c_uint32)]
            lib.read_dpt.restype = ctypes.c_int
            lib.batch_read_dpt.argtypes = [
                ctypes.c_char_p, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_uint16), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_uint32),
                ctypes.POINTER(ctypes.c_int), ctypes.c_int]
            lib.batch_read_dpt.restype = None
            _lib = lib
        except (OSError, subprocess.CalledProcessError) as exc:
            _lib, _error = None, exc
    return _lib


def available():
    """Whether the native reader is in use (else the numpy reader is)."""
    return _load() is not None


def describe():
    """One line saying which ``.dpt`` reader runs, and why."""
    if available():
        return f"native .dpt reader in use ({library_path().name})"
    return f"numpy .dpt reader in use: the native one did not build ({_error})"


def read_dpt(path, max_hw=(1024, 1280)):
    """Native .dpt read; falls back to the numpy reader."""
    lib = _load()
    if lib is None:
        from rcvpose_tpu_torch.data import readers
        return readers.read_depth(str(path))
    max_elems = max_hw[0] * max_hw[1]
    out = np.empty(max_elems, np.uint16)
    h = ctypes.c_uint32()
    w = ctypes.c_uint32()
    rc = lib.read_dpt(str(path).encode(),
                      out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
                      max_elems, ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        raise IOError(f"read_dpt({path}) failed with code {rc}")
    return out[: h.value * w.value].reshape(h.value, w.value).copy()


def batch_read_dpt(paths, max_hw=(1024, 1280), n_threads=0):
    """Threaded batch .dpt read -> list of (H, W) uint16 arrays."""
    lib = _load()
    if lib is None:
        from rcvpose_tpu_torch.data import readers
        return [readers.read_depth(str(p)) for p in paths]
    n = len(paths)
    max_elems = max_hw[0] * max_hw[1]
    out = np.empty((n, max_elems), np.uint16)
    dims = np.zeros((n, 2), np.uint32)
    status = np.zeros(n, np.int32)
    joined = "\n".join(str(p) for p in paths).encode()
    lib.batch_read_dpt(
        joined, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        max_elems, dims.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), n_threads)
    results = []
    for i in range(n):
        if status[i] != 0:
            raise IOError(f"batch_read_dpt({paths[i]}) code {status[i]}")
        h, w = int(dims[i, 0]), int(dims[i, 1])
        results.append(out[i, : h * w].reshape(h, w).copy())
    return results
