"""A read-only reader of OCDBT, the key-value store that orbax checkpoints
live in (tensorstore's log-structured B+tree, ``"driver": "ocdbt"``).

The port reads the JAX package's checkpoints with it on machines that have
no ``tensorstore``. What it reads, all checked against tensorstore 0.1.80:

- ``manifest.ocdbt`` at the store's root: a header (big-endian magic
  ``0x0cdb3a2a``, u64 file length, version 0, compression 0 or 1 = zstd),
  the body, and a CRC-32C trailer. The body holds the config (uuid,
  manifest kind, inline and node size limits, version-tree arity,
  compression), a data-file table and the newest versions, each with its
  root B-tree node reference.
- B-tree nodes (magic ``0x0cdb20de``, the same header and trailer): the
  height, a data-file table, prefix-compressed keys, and for a leaf the
  values (inline, or indirect: file, offset, length); for an interior node
  each child's reference and the key prefix its subtree shares.
- Data files are named by paths relative to the root (``d/<hash>``, or
  ``ocdbt.process_<n>/d/<hash>`` in a directory merged from several
  processes); a lookup reads only the nodes and byte ranges it needs.

Anything else is refused by name (``OcdbtStore._refuse``).
"""

from __future__ import annotations

import bisect
import os
import struct
import threading

from rcvpose_tpu_torch.native import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
_NO_ROOT = (1 << 64) - 1


class _Cursor:
    """Bounds-checked reads of an encoded body."""

    def __init__(self, data, what):
        self.data = memoryview(data)
        self.pos = 0
        self.what = what

    def _need(self, n):
        if self.pos + n > len(self.data):
            raise ValueError(f"OCDBT: {self.what} is truncated")

    def u8(self):
        self._need(1)
        self.pos += 1
        return self.data[self.pos - 1]

    def varint(self):
        value = shift = 0
        while True:
            b = self.u8()
            value |= (b & 0x7F) << shift
            if not b & 0x80:
                return value
            shift += 7
            if shift > 63:
                raise ValueError(f"OCDBT: bad varint in {self.what}")

    def varints(self, n):
        return [self.varint() for _ in range(n)]

    def take(self, n):
        self._need(n)
        self.pos += n
        return bytes(self.data[self.pos - n:self.pos])

    def u64le(self):
        return struct.unpack("<Q", self.take(8))[0]


class OcdbtStore:
    """``list(prefix)`` and ``read(key)`` over an OCDBT directory's newest
    version. ``bytes_read`` counts the bytes read from disk."""

    def __init__(self, root):
        self.root = os.path.abspath(root)
        self.bytes_read = 0
        self._lock = threading.Lock()
        self._load_lock = threading.Lock()
        self._nodes = {}
        self._full_keys = {}
        self._node_limit = 1 << 31  # until the config names its own
        body = self._decode(self._read_file("manifest.ocdbt"),
                            MANIFEST_MAGIC, "manifest.ocdbt")
        c = _Cursor(body, "manifest.ocdbt")
        c.take(16)  # uuid
        if c.varint() != 0:
            self._refuse("a numbered manifest (manifest_kind 1)")
        c.varint()  # max inline value bytes
        self._node_limit = max(c.varint(), 1 << 20)  # max decoded node
        c.u8()  # version tree arity (log2)
        method = c.varint()
        if method == 1:
            c.take(4)  # zstd level, int32
        elif method != 0:
            self._refuse(f"node compression method {method}")
        files = self._data_files(c)
        n = c.varint()
        if n == 0:
            self._refuse("a manifest without an inline version")
        gens = c.varints(n)
        heights = [c.u8() for _ in range(n)]
        ids, offsets, lengths = c.varints(n), c.varints(n), c.varints(n)
        newest = max(range(n), key=gens.__getitem__)
        if offsets[newest] == _NO_ROOT:
            self._root = None  # an empty store
        else:
            self._root = (self._file(files, ids[newest]), offsets[newest],
                          lengths[newest], heights[newest])

    @staticmethod
    def _refuse(why):
        raise ValueError(f"OCDBT: {why} is not supported by the port's "
                         "reader (it reads what orbax 0.11 with tensorstore "
                         "0.1 writes)")

    # ------------------------------------------------------------- files

    def _read_file(self, rel, offset=0, length=None):
        path = os.path.join(self.root, rel)
        with open(path, "rb") as f:
            f.seek(offset)
            data = f.read() if length is None else f.read(length)
        if length is not None and len(data) != length:
            raise ValueError(f"OCDBT: {rel} ends before byte "
                             f"{offset + length}")
        with self._lock:
            self.bytes_read += len(data)
        return data

    def _decode(self, data, magic, what):
        """Header, CRC-32C trailer and (zstd) body of a manifest or node."""
        if len(data) < 4:
            raise ValueError(f"OCDBT: {what} is truncated")
        found = struct.unpack(">I", data[:4])[0]
        if found != magic:
            self._refuse(f"magic {found:#010x} in {what} (expected "
                         f"{magic:#010x})")
        c = _Cursor(data, what)
        c.take(4)
        if c.u64le() != len(data):
            raise ValueError(f"OCDBT: {what}'s length field is not its size")
        version = c.varint()
        if version != 0:
            self._refuse(f"format version {version} in {what}")
        compression = c.varint()
        if len(data) < c.pos + 4:
            raise ValueError(f"OCDBT: {what} is truncated")
        want = struct.unpack("<I", data[-4:])[0]
        if zstd.crc32c(memoryview(data)[:-4]) != want:
            raise ValueError(f"OCDBT: CRC-32C mismatch in {what}")
        body = data[c.pos:-4]
        if compression == 1:
            return zstd.decompress(body, limit=self._node_limit)
        if compression != 0:
            self._refuse(f"compression format {compression} in {what}")
        return body

    def _data_files(self, c):
        n = c.varint()
        prefix = [0] + c.varints(n - 1) if n else []
        suffix = c.varints(n)
        base = c.varints(n)
        paths, prev = [], b""
        for i in range(n):
            if prefix[i] > len(prev):
                raise ValueError("OCDBT: bad data-file table")
            full = prev[:prefix[i]] + c.take(suffix[i])
            if base[i] > len(full):
                raise ValueError("OCDBT: bad data-file table")
            path = full.decode()
            parts = path.split("/")
            if path.startswith("/") or ".." in parts:
                self._refuse(f"data-file path {path!r} outside the store")
            paths.append(path)
            prev = full
        return paths

    @staticmethod
    def _file(files, index):
        if index >= len(files):
            raise ValueError(f"OCDBT: data file {index} is not in the table")
        return files[index]

    # ------------------------------------------------------------- nodes

    def _node(self, ref):
        """Parsed B-tree node at ``ref = (file, offset, length, height)``,
        read once however many threads ask for it."""
        with self._lock:
            hit = self._nodes.get(ref)
        if hit is not None:
            return hit
        with self._load_lock:
            with self._lock:
                hit = self._nodes.get(ref)
            return hit if hit is not None else self._load_node(ref)

    def _load_node(self, ref):
        rel, offset, length, height = ref
        what = f"B-tree node {rel}@{offset}"
        body = self._decode(self._read_file(rel, offset, length),
                            NODE_MAGIC, what)
        c = _Cursor(body, what)
        if c.u8() != height:
            raise ValueError(f"OCDBT: {what} has another height than its "
                             "reference says")
        files = self._data_files(c)
        n = c.varint()
        prefix = [0] + c.varints(n - 1) if n else []
        suffix = c.varints(n)
        common = c.varints(n) if height else None
        keys, prev = [], b""
        for i in range(n):
            if prefix[i] > len(prev):
                raise ValueError(f"OCDBT: bad key prefix in {what}")
            prev = prev[:prefix[i]] + c.take(suffix[i])
            keys.append(prev)
        if height:
            ids, offsets, lengths = c.varints(n), c.varints(n), c.varints(n)
            c.varints(3 * n)  # statistics: keys, tree bytes, indirect bytes
            entries = []
            for i in range(n):
                if common[i] > len(keys[i]):
                    raise ValueError(f"OCDBT: bad subtree prefix in {what}")
                entries.append((keys[i], common[i],
                                (self._file(files, ids[i]), offsets[i],
                                 lengths[i], height - 1)))
        else:
            sizes = c.varints(n)
            kinds = c.varints(n)
            if any(k > 1 for k in kinds):
                self._refuse(f"value kind {max(kinds)} in {what}")
            k = sum(kinds)
            ids, offsets = c.varints(k), c.varints(k)
            entries, j = [], 0
            for i in range(n):
                if kinds[i]:
                    entries.append((keys[i], (self._file(files, ids[j]),
                                              offsets[j], sizes[i])))
                    j += 1
                else:
                    entries.append((keys[i], c.take(sizes[i])))
        node = (height, entries)
        with self._lock:
            self._nodes[ref] = node
        return node

    def _leaves(self, lo, hi):
        """(key, value) of every leaf entry whose key may lie in [lo, hi)
        (``hi`` None: no upper end), in key order."""
        if self._root is None:
            return
        stack = [(self._root, b"")]
        while stack:
            ref, node_prefix = stack.pop()
            height, entries = self._node(ref)
            if height == 0:
                for key, value in entries:
                    yield node_prefix + key, value
                continue
            kids = []
            for i, (key, common, child) in enumerate(entries):
                first = node_prefix + key
                nxt = (node_prefix + entries[i + 1][0]
                       if i + 1 < len(entries) else None)
                if nxt is not None and nxt <= lo:
                    continue
                if hi is not None and first >= hi:
                    continue
                kids.append((child, node_prefix + key[:common]))
            stack.extend(reversed(kids))

    def _value(self, value):
        if isinstance(value, bytes):
            return value
        rel, offset, length = value
        return self._read_file(rel, offset, length)

    # -------------------------------------------------------------- API

    def list(self, prefix=b""):
        """Keys (bytes) that start with ``prefix``, in order."""
        prefix = _as_bytes(prefix)
        return [key for key, _ in self._leaves(prefix, _prefix_end(prefix))
                if key.startswith(prefix)]

    def read(self, key):
        """The value of ``key`` (bytes), or None when it is absent."""
        key = _as_bytes(key)
        if self._root is None:
            return None
        ref, prefix = self._root, b""
        while True:
            height, full, entries = self._index(ref, prefix)
            if height == 0:
                i = bisect.bisect_left(full, key)
                if i < len(full) and full[i] == key:
                    return self._value(entries[i][1])
                return None
            i = bisect.bisect_right(full, key) - 1
            if i < 0:
                return None
            child_key, common, ref = entries[i]
            prefix = prefix + child_key[:common]
            if not key.startswith(prefix):
                return None

    def _index(self, ref, prefix):
        """A node with its entries' full keys (sorted), for lookups."""
        with self._lock:
            hit = self._full_keys.get(ref)
        if hit is None:
            height, entries = self._node(ref)
            hit = (height, [prefix + e[0] for e in entries], entries)
            with self._lock:
                self._full_keys[ref] = hit
        return hit


def _as_bytes(key):
    return key.encode() if isinstance(key, str) else bytes(key)


def _prefix_end(prefix):
    """The least key above every key that starts with ``prefix``."""
    p = bytearray(prefix)
    while p and p[-1] == 0xFF:
        p.pop()
    if not p:
        return None
    p[-1] += 1
    return bytes(p)
