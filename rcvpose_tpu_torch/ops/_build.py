"""Builds the port's CUDA sources at first use and loads them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
alone (no PyTorch headers) into the library directory, by default
``rcvpose_tpu_torch/_build/``, which git ignores; ``set_build_dir`` (through
``utils.enable_compile_cache`` and ``--compile_cache_dir``) moves it before
the first library loads. The library's file name carries a hash of its
source and the flags, so an edited source builds anew and an unchanged one
is reused, and each build writes a per-process temporary file that then
replaces the target, so processes may share the directory. Nothing is
prebuilt and nothing is downloaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from rcvpose_tpu_torch import profiling

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
SOURCES = ("vote", "heads", "mmconv", "icp", "epilogue")

_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[tuple[str, str], object] = {}
_loaded_from: dict[str, Path] = {}   # library name -> its directory
_lock = threading.Lock()


def _nvcc():
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build rcvpose_tpu_torch/csrc")
    return found


def library_path(name):
    """Where the library built from ``csrc/<name>.cu`` lives."""
    src = CSRC / f"{name}.cu"
    key = hashlib.sha256(src.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{key}.so"


def build(names=SOURCES):
    """Build every named source that is not built yet: one ``nvcc`` for
    each, all started together. Returns ``{name: compiler output}`` for the
    sources built now; raises with the compiler output if one fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, proc, tmp, out))
    logs, failures = {}, []
    for name, proc, tmp, out in jobs:
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failures.append(f"nvcc failed on {name}.cu "
                            f"(exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if failures:
        raise RuntimeError("\n".join(failures))
    return logs


def loaded_elsewhere(path):
    """Names of the libraries this process loaded from a directory other
    than ``path``."""
    path = Path(path).resolve()
    return sorted(n for n, d in _loaded_from.items() if d != path)


def set_build_dir(path):
    """Build and load the libraries in ``path`` from now on (made if
    missing). ``utils.enable_compile_cache`` calls it once it has checked
    that no library is loaded from elsewhere."""
    path = Path(path).resolve()
    path.mkdir(parents=True, exist_ok=True)
    with _lock:
        global BUILD_DIR
        BUILD_DIR = path


def load(name):
    """The library built from ``csrc/<name>.cu``, built if missing and
    loaded once a process."""
    with _lock:
        return _load(name)


def _load(name):
    lib = _libs.get(name)
    if lib is None:
        path = library_path(name)
        built = not path.exists()
        with profiling.span("rcvpose.kernels.load", library=name,
                            built=built):
            build((name,))
            lib = ctypes.CDLL(str(path))
        _count_load(built)
        _libs[name] = lib
        _loaded_from[name] = BUILD_DIR.resolve()
    return lib


def _count_load(built):
    profiling.count("kernels.loaded")
    if built:
        profiling.count("kernels.built")


def function(name, symbol, argtypes):
    """The C entry ``symbol`` of ``csrc/<name>.cu``, typed with ``argtypes``
    and returning an int (a CUDA error code); the library is built and
    loaded at the first call."""
    with _lock:
        fn = _fns.get((name, symbol))
        if fn is None:
            fn = getattr(_load(name), symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _fns[(name, symbol)] = fn
        return fn


def load_other(source):
    """Build another ``.cu`` file (an earlier version of a source, for a
    before-and-after timing) with the same flags into ``other/`` under the
    library directory and load it; returns the ``ctypes.CDLL``. Rebuilt
    only when its content changes."""
    source = Path(source)
    key = hashlib.sha256(source.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / "other" / f"lib{source.stem}_{key}.so"
    built = not out.exists()
    with profiling.span("rcvpose.kernels.load", library=source.name,
                        built=built):
        if built:
            out.parent.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                                   str(source)], capture_output=True,
                                  text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {source}:\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
    _count_load(built)
    with _lock:
        _loaded_from[f"other/{source.stem}"] = BUILD_DIR.resolve()
    return lib


def count(fn, attr="launches", n=1):
    """Add ``n`` to the launch counter ``fn.<attr>`` under the counters'
    lock (``profiling.count``)."""
    profiling.count(attr, n, owner=fn)


def check(err, what):
    """Raise if a C entry returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
