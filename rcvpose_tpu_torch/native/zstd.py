"""ctypes binding of the port's Zstandard decoder and CRC-32C
(``zstd.cpp``), which read the JAX package's orbax checkpoints.

The library builds with ``g++`` at first use into the library directory
(``native.BUILD_DIR``), as ``rcvpose_io.cpp`` does. There is no
fallback: without ``g++``, or when the build fails, every call raises a
``RuntimeError`` that names the decoder. Malformed input raises
``ValueError``.

``STATS`` counts the frames, block modes, literal modes and sequence-table
modes the decoder met since the last ``reset_stats()``.
"""

from __future__ import annotations

import ctypes
import subprocess
import threading
from pathlib import Path

import numpy as np

from rcvpose_tpu_torch import native

SRC = Path(__file__).resolve().parent / "zstd.cpp"
STAT_NAMES = (
    "frames", "skippable_frames", "raw_blocks", "rle_blocks",
    "compressed_blocks", "raw_literals", "rle_literals", "huffman_1_stream",
    "huffman_4_streams", "treeless_literals", "predefined_tables",
    "rle_tables", "fse_tables", "repeat_tables", "checksums", "sequences")
_ERRORS = {
    -1: "truncated input", -2: "corrupt input",
    -3: "output larger than the buffer", -4: "a dictionary is required",
    -5: "content checksum mismatch", -6: "frame content size mismatch",
    -7: "no zstd frame", -8: "out of memory"}
_lock = threading.Lock()
_lib = None
_error = None
STATS = dict.fromkeys(STAT_NAMES, 0)


def _load():
    global _lib, _error
    with _lock:
        if _lib is None and _error is None:
            try:
                lib = native.load_library(SRC)
            except (OSError, subprocess.CalledProcessError) as exc:
                detail = getattr(exc, "stderr", b"") or b""
                _error = f"{exc} {detail.decode(errors='replace')[-2000:]}"
            else:
                lib.rz_decompress.argtypes = [
                    ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
                    ctypes.c_size_t, ctypes.POINTER(ctypes.c_int64)]
                lib.rz_decompress.restype = ctypes.c_int64
                lib.rz_content_size.argtypes = [
                    ctypes.c_void_p, ctypes.c_size_t,
                    ctypes.POINTER(ctypes.c_uint64)]
                lib.rz_content_size.restype = ctypes.c_int
                lib.rz_crc32c.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
                lib.rz_crc32c.restype = ctypes.c_uint32
                lib.rz_n_stats.restype = ctypes.c_int
                if lib.rz_n_stats() != len(STAT_NAMES):
                    _error = "stat count differs from zstd.cpp"
                else:
                    _lib = lib
    if _lib is None:
        raise RuntimeError(
            f"the zstd decoder ({SRC.name}, built with g++ into "
            f"{native.BUILD_DIR}) is not available: {_error}")
    return _lib


def _address(buf):
    """(address, length) of a bytes-like or numpy buffer, and what to
    keep alive while it is used."""
    arr = np.frombuffer(buf, np.uint8) if not isinstance(buf, np.ndarray) \
        else buf.reshape(-1).view(np.uint8)
    return arr.ctypes.data, arr.size, arr


def reset_stats():
    for k in STATS:
        STATS[k] = 0


def _raise(code, what):
    raise ValueError(f"zstd: {what}: {_ERRORS.get(code, f'error {code}')}")


def decompress_into(data, out):
    """Decode every frame of ``data`` into the writable numpy array ``out``,
    which must be filled exactly (the frames' decoded length is its byte
    size). Returns ``out``."""
    lib = _load()
    src, n, keep = _address(data)
    if not out.flags.c_contiguous or not out.flags.writeable:
        raise ValueError("zstd: the output must be a writable C-contiguous "
                         "array")
    cap = out.nbytes
    stats = (ctypes.c_int64 * len(STAT_NAMES))()
    got = lib.rz_decompress(src, n, out.ctypes.data if cap else None, cap,
                            stats)
    del keep
    with _lock:
        for name, v in zip(STAT_NAMES, stats):
            STATS[name] += v
    if got < 0:
        _raise(got, f"{n} bytes into a {cap}-byte buffer")
    if got != cap:
        raise ValueError(f"zstd: decoded {got} bytes where {cap} were "
                         "expected")
    return out


def decompress(data, size=None, limit=1 << 31):
    """Decode ``data`` to bytes. ``size``: the decoded length, when the
    caller knows it (else the frames' content sizes, else a growing
    buffer); another length raises ``ValueError``, as does a decoded
    length over ``limit`` bytes."""
    lib = _load()
    if size is None:
        src, n, keep = _address(data)
        total = ctypes.c_uint64()
        rc = lib.rz_content_size(src, n, ctypes.byref(total))
        del keep
        if rc < 0:
            _raise(rc, f"{n} bytes")
        if rc == 1:
            size = total.value
        else:
            cap = min(max(4 * len(data), 1 << 16), limit)
            while True:
                out = np.empty(cap, np.uint8)
                stats = (ctypes.c_int64 * len(STAT_NAMES))()
                src, n, keep = _address(data)
                got = lib.rz_decompress(src, n, out.ctypes.data, cap, stats)
                if got != -3 or cap >= limit:
                    break
                cap = min(4 * cap, limit)
            if got < 0:
                _raise(got, f"{n} bytes")
            with _lock:
                for name, v in zip(STAT_NAMES, stats):
                    STATS[name] += v
            return out[:got].tobytes()
    if size > limit:
        raise ValueError(f"zstd: {size} decoded bytes are over the limit "
                         f"of {limit}")
    out = np.empty(int(size), np.uint8)
    return decompress_into(data, out).tobytes()


def crc32c(data):
    """CRC-32C (Castagnoli) of a bytes-like object."""
    lib = _load()
    src, n, keep = _address(data)
    return int(lib.rz_crc32c(src, n))
