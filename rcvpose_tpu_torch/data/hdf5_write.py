"""A streaming HDF5 writer for machines without h5py.

It writes the layout the port's own reader (``readers.Hdf5File``) reads
and h5py writes by default (HDF5 file format specification 3.0):

- a version-0 superblock (8-byte offsets and lengths, group leaf node K 4,
  group internal node K 16, chunk B-tree K 32);
- symbol-table groups: a local heap of names (``HEAP``), symbol-table
  nodes (``SNOD``, up to 2 x leaf K = 8 entries each) and a version-1
  B-tree of group nodes (``TREE``, up to 2 x internal K = 32 children a
  node, as many levels as the names need), names in byte order;
- version-1 object headers: a symbol-table message for a group; for a
  dataset a simple dataspace, a little-endian fixed-point or IEEE float
  datatype and a version-3 layout: contiguous with no filter, or (with
  ``gzip``) one chunk holding the whole array, a filter pipeline with
  deflate (id 1) at that level and a version-1 raw-data chunk B-tree.
  ``zlib.compress(raw, level)`` is what HDF5's deflate filter stores.

Each dataset's data goes to disk as it is added; groups, their heaps,
symbol-table nodes and B-trees are written by ``close``, which then fills
in the superblock. The file is written beside the target and moved over
it by ``close`` (``os.replace``), so a reader never sees half a file and
a failed write leaves the target as it was.

``Hdf5Writer(path, mode="a")`` is h5py's ``"a"`` mode as the YCB label
generator uses it: the existing file is read with ``readers._Hdf5Names``
(never h5py), ``name in w`` sees its objects, ``del w[name]`` drops one,
and ``close`` carries every object left over into the new file as stored,
chunk bytes, filter masks and offsets unchanged, with no decompression.
What the reader refuses (another layout, filter or message) stays refused.

    with hdf5_write.Hdf5Writer(path) as w:
        w.add("JPEGImages/0000_000001", image)          # gzip 9
    hdf5_write.write_hdf5(path, {"a/b": array})         # contiguous
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
OFFSET = 8                  # size of offsets and of lengths
UNDEFINED = (1 << 64) - 1   # the undefined address
LEAF_K = 4                  # group leaf node K: 2K entries a SNOD
INTERNAL_K = 16             # group internal node K: 2K children a TREE
CHUNK_K = 32                # chunk B-tree K (fixed by a v0 superblock)
SUPERBLOCK_SIZE = 96        # v0 fields + the root's symbol-table entry
ENTRY_SIZE = 2 * OFFSET + 24
HEAP_FREE_NULL = 1          # "no free block" in a local heap's free list

# object header message types
_DATASPACE, _DATATYPE, _LAYOUT, _FILTERS, _SYMBOL_TABLE = \
    0x01, 0x03, 0x08, 0x0B, 0x11
# float layouts: size -> (exponent location, exponent size, mantissa
# size, exponent bias)
_FLOATS = {2: (10, 5, 10, 15), 4: (23, 8, 23, 127), 8: (52, 11, 52, 1023)}


def _pad8(n):
    return (n + 7) // 8 * 8


def _datatype(dtype):
    """The datatype message of a numpy dtype (little-endian)."""
    size = dtype.itemsize
    if dtype.kind in "iu" and size in (1, 2, 4, 8):
        bits = 0x08 if dtype.kind == "i" else 0x00
        return (struct.pack("<BBBBI", 0x10, bits, 0, 0, size)
                + struct.pack("<HH", 0, 8 * size))
    if dtype.kind == "f" and size in _FLOATS:
        exp_at, exp_size, mant_size, bias = _FLOATS[size]
        # bit field: mantissa normalization 2 (msb implied), sign bit
        return (struct.pack("<BBBBI", 0x11, 0x20, 8 * size - 1, 0, size)
                + struct.pack("<HHBBBBI", 0, 8 * size, exp_at, exp_size, 0,
                              mant_size, bias))
    raise TypeError(f"hdf5_write: no HDF5 datatype for {dtype}: it writes "
                    "(u)int8-64 and float16/32/64")


def _deflate_pipeline(level):
    """A version-1 filter pipeline message: deflate (id 1, optional) with
    its one client value, the level, as h5py writes it."""
    return (struct.pack("<BB6x", 1, 1)
            + struct.pack("<HHHH", 1, 8, 1, 1) + b"deflate\0"
            + struct.pack("<I4x", level))


def _entry(name_offset, header, group_tables=None):
    """A symbol-table entry: cache type 1 with the group's (B-tree, heap)
    addresses in the scratch pad, else 0."""
    if group_tables is None:
        return struct.pack("<QQII16x", name_offset, header, 0, 0)
    return struct.pack("<QQIIQQ", name_offset, header, 1, 0, *group_tables)


def _chunk_key(size, mask, offset):
    return struct.pack(f"<II{len(offset)}Q", size, mask, *offset)


class _Group:
    """A group being written: members {name: _Group or dataset header
    address} and the messages its header keeps besides the symbol table
    (a carried group's attributes)."""

    def __init__(self, messages=()):
        self.members = {}
        self.messages = list(messages)


class Hdf5Writer:
    """Write an HDF5 file dataset by dataset (see the module docstring).

    ``mode="w"`` makes a new file, ``"a"`` keeps an existing one's objects
    unless they are deleted or replaced (a missing file is made anew).
    Use it as a context manager, or call ``close``; ``abort`` (what an
    exception inside ``with`` calls) removes the partial file and leaves
    the target untouched."""

    def __init__(self, path, mode="w"):
        if mode not in ("w", "a"):
            raise ValueError(f"hdf5_write: mode {mode!r}: 'w' or 'a'")
        self.path = str(path)
        self._src, self._kept = None, {}
        if mode == "a" and os.path.exists(self.path):
            from rcvpose_tpu_torch.data import readers

            self._src = readers._Hdf5Names(self.path)
            try:
                # check every object now, before any work is done
                for name, entry, group in self._src.walk():
                    self._kept[name] = (entry, group,
                                        self._src.object_messages(entry),
                                        None if group
                                        else self._src.stored(entry))
            except BaseException:
                self._src.close()
                raise
        self._tmp = f"{self.path}.{os.getpid()}.tmp"
        self._f = open(self._tmp, "wb")
        self._f.write(b"\0" * SUPERBLOCK_SIZE)
        self._pos = SUPERBLOCK_SIZE
        self._root = _Group(() if self._src is None else
                            self._src.object_messages(self._src.root))
        self._added = set()

    # -- names ----------------------------------------------------------

    def __contains__(self, name):
        parts = [p for p in name.split("/") if p]
        if "/".join(parts) in self._kept:
            return True
        node = self._root
        for part in parts:
            if not isinstance(node, _Group) or part not in node.members:
                return False
            node = node.members[part]
        return True

    def __delitem__(self, name):
        """Drop ``name`` (a group with its members) of the existing file."""
        name = "/".join(p for p in name.split("/") if p)
        kept = self._kept.pop(name, None)
        if kept is None:
            raise KeyError(f"hdf5_write: no object {name!r} of the existing "
                           "file to delete")
        if kept[1]:
            for n in [n for n in self._kept if n.startswith(name + "/")]:
                del self._kept[n]

    def _parts(self, name):
        parts = [p for p in name.split("/") if p]
        if not parts or any(p == "." or "\0" in p for p in parts):
            raise ValueError(f"hdf5_write: bad dataset name {name!r}")
        return parts

    def _place(self, parts, what):
        """Put ``what`` (a dataset's header address or a _Group) at
        ``parts`` in the tree, making groups on the way; a group placed
        where one was made on the way gives it its messages."""
        node = self._root
        for part in parts[:-1]:
            node = node.members.setdefault(part, _Group())
            if not isinstance(node, _Group):
                raise ValueError(f"hdf5_write: {'/'.join(parts)!r} passes "
                                 "through a dataset")
        old = node.members.get(parts[-1])
        if isinstance(old, _Group) and isinstance(what, _Group):
            old.messages = what.messages or old.messages
            return
        if old is not None:
            raise ValueError(f"hdf5_write: {'/'.join(parts)!r} written "
                             "twice")
        node.members[parts[-1]] = what

    # -- the file -------------------------------------------------------

    def _append(self, raw):
        """Write ``raw`` 8-byte aligned at the end; returns its address."""
        at = _pad8(self._pos)
        self._f.write(b"\0" * (at - self._pos) + raw)
        self._pos = at + len(raw)
        return at

    def _object_header(self, messages):
        """A version-1 object header holding ``messages`` [(type, flags,
        data)], each padded to 8 bytes; returns its address."""
        body = b""
        for mtype, flags, data in messages:
            data = data + b"\0" * (_pad8(len(data)) - len(data))
            body += struct.pack("<HHB3x", mtype, len(data), flags) + data
        prefix = struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body))
        return self._append(prefix + body)

    def _chunk_btree(self, dims, records):
        """A version-1 raw-data chunk B-tree over ``records`` [(address,
        size, filter mask, offset)], sorted by offset, up to 2 x CHUNK_K
        children a node; returns the root's address."""
        per = 2 * CHUNK_K
        key_size = 8 + 8 * len(dims)
        node_size = 8 + 2 * OFFSET + per * OFFSET + (per + 1) * key_size
        # (address, first key, last key) of the children of this level
        children = []
        for addr, size, mask, offset in sorted(records, key=lambda r: r[3]):
            right = tuple(o + d for o, d in zip(offset, dims))
            children.append((addr, _chunk_key(size, mask, offset),
                             _chunk_key(0, 0, right)))
        level = 0
        while True:
            groups = [children[i:i + per]
                      for i in range(0, len(children), per)] or [[]]
            start = _pad8(self._pos)
            addrs = [start + i * node_size for i in range(len(groups))]
            nodes = []
            for i, group in enumerate(groups):
                left = addrs[i - 1] if i else UNDEFINED
                right = addrs[i + 1] if i + 1 < len(groups) else UNDEFINED
                raw = struct.pack("<4sBBHQQ", b"TREE", 1, level, len(group),
                                  left, right)
                for addr, first, _ in group:
                    raw += first + struct.pack("<Q", addr)
                raw += group[-1][2] if group else _chunk_key(
                    0, 0, (0,) * len(dims))
                raw += b"\0" * (node_size - len(raw))
                if self._append(raw) != addrs[i]:
                    raise AssertionError("hdf5_write: B-tree nodes not "
                                         "contiguous")
                if group:
                    nodes.append((addrs[i], group[0][1], group[-1][2]))
            if len(nodes) <= 1:
                return addrs[0]
            children, level = nodes, level + 1

    def _contiguous(self, raw):
        """Write ``raw``; returns its contiguous layout message (no address
        for no bytes, as HDF5 writes it)."""
        at = self._append(raw) if raw else UNDEFINED
        return struct.pack("<BBQQ", 3, 1, at, len(raw))

    def _dataset_header(self, messages, layout):
        return self._object_header(messages + [(_LAYOUT, 0, layout)])

    def add(self, name, array, gzip=9):
        """Write ``array`` (numpy, (u)int8-64 or float16/32/64) as the
        dataset ``name`` (``/``-separated; groups on the way are made).
        ``gzip``: a deflate level 0-9 (one chunk, the whole array), or None
        for a contiguous dataset. A scalar or empty array is contiguous
        either way, as HDF5 chunks neither. Replacing an object of the
        existing file needs ``del`` first, as in h5py."""
        parts = self._parts(name)
        key = "/".join(parts)
        if key in self._kept or key in self._added:
            raise ValueError(f"hdf5_write: {key!r} written twice")
        arr = np.asarray(array)
        dtype = arr.dtype.newbyteorder("<")
        messages = [(_DATASPACE, 0, struct.pack("<BBB5x", 1, arr.ndim, 0)
                     + b"".join(struct.pack("<Q", n) for n in arr.shape)),
                    (_DATATYPE, 1, _datatype(dtype))]
        raw = np.ascontiguousarray(arr, dtype).tobytes()    # C order
        if gzip is None or arr.ndim == 0 or arr.size == 0:
            layout = self._contiguous(raw)
        else:
            data = zlib.compress(raw, gzip)
            dims = arr.shape + (dtype.itemsize,)
            btree = self._chunk_btree(
                dims, [(self._append(data), len(data), 0, (0,) * len(dims))])
            messages.append((_FILTERS, 1, _deflate_pipeline(gzip)))
            layout = struct.pack(f"<BBBQ{len(dims)}I", 3, 2, len(dims), btree,
                                 *dims)
        self._place(parts, self._dataset_header(messages, layout))
        self._added.add(key)

    def _carry(self):
        """Copy every object left of the existing file as stored."""
        src = self._src
        for name, (entry, group, messages, stored) in self._kept.items():
            parts = name.split("/")
            if group:
                self._place(parts, _Group(messages))
                continue
            if stored[0] == "contiguous":
                _, at, size = stored
                layout = self._contiguous(bytes(src.data[at:at + size]))
            else:
                _, dims, records = stored
                copied = [(self._append(bytes(src.data[at:at + size])), size,
                           mask, offset)
                          for at, size, mask, offset in records]
                btree = (self._chunk_btree(dims, copied) if copied
                         else UNDEFINED)
                layout = struct.pack(f"<BBBQ{len(dims)}I", 3, 2, len(dims),
                                     btree, *dims)
            self._place(parts, self._dataset_header(messages, layout))

    def _btree_level(self, children, level):
        """Write one level of group B-tree nodes over ``children``
        [(address, left key, right key)] (name offsets as keys), each node
        with up to 2 x INTERNAL_K children and sibling links. Returns the
        nodes as [(address, left key, right key)]."""
        per = 2 * INTERNAL_K
        chunks = [children[i:i + per] for i in range(0, len(children), per)]
        chunks = chunks or [[]]
        size = 8 + 2 * OFFSET + (per + 1) * OFFSET + per * OFFSET
        start = _pad8(self._pos)
        addrs = [start + i * size for i in range(len(chunks))]
        nodes = []
        for i, chunk in enumerate(chunks):
            left = addrs[i - 1] if i else UNDEFINED
            right = addrs[i + 1] if i + 1 < len(chunks) else UNDEFINED
            left_key = chunk[0][1] if chunk else 0
            raw = struct.pack("<4sBBHQQ", b"TREE", 0, level, len(chunk), left,
                              right) + struct.pack("<Q", left_key)
            for addr, _, right_key in chunk:
                raw += struct.pack("<QQ", addr, right_key)
            raw += b"\0" * (size - len(raw))
            if self._append(raw) != addrs[i]:
                raise AssertionError("hdf5_write: B-tree nodes not "
                                     "contiguous")
            nodes.append((addrs[i], left_key,
                          chunk[-1][2] if chunk else left_key))
        return nodes

    def _write_group(self, group):
        """Write a group's member groups, its local heap, symbol-table
        nodes and B-tree, and its object header. Returns (header address,
        B-tree address, heap address)."""
        names = sorted(group.members, key=lambda s: s.encode())
        entries = []
        heap_data = bytearray(8)       # offset 0: the empty name
        for name in names:
            offset = len(heap_data)
            raw = name.encode()
            heap_data.extend(raw + b"\0" * (_pad8(len(raw) + 1) - len(raw)))
            value = group.members[name]
            if isinstance(value, _Group):
                header, btree, heap = self._write_group(value)
                entries.append((offset, _entry(offset, header, (btree, heap))))
            else:
                entries.append((offset, _entry(offset, value)))
        heap = _pad8(self._pos)
        # the heap's data follows its 32-byte header
        self._append(struct.pack("<4sB3xQQQ", b"HEAP", 0, len(heap_data),
                                 HEAP_FREE_NULL, heap + 32))
        if self._append(bytes(heap_data)) != heap + 32:
            raise AssertionError("hdf5_write: heap data not after its header")

        per = 2 * LEAF_K
        leaves = []
        prev_key = 0
        for i in range(0, len(entries), per):
            chunk = entries[i:i + per]
            raw = struct.pack("<4sBBH", b"SNOD", 1, 0, len(chunk))
            raw += b"".join(e for _, e in chunk)
            raw += b"\0" * (8 + per * ENTRY_SIZE - len(raw))
            leaves.append((self._append(raw), prev_key, chunk[-1][0]))
            prev_key = chunk[-1][0]
        level, nodes = 0, self._btree_level(leaves, 0)
        while len(nodes) > 1:
            level += 1
            nodes = self._btree_level(nodes, level)
        btree = nodes[0][0]
        header = self._object_header(
            [(_SYMBOL_TABLE, 0, struct.pack("<QQ", btree, heap))]
            + group.messages)
        return header, btree, heap

    def close(self):
        """Carry what is kept of the existing file, write the groups and
        the superblock, and move the file over the target."""
        if self._f is None:
            return
        try:
            if self._src is not None:
                self._carry()
            header, btree, heap = self._write_group(self._root)
            eof = _pad8(self._pos)
            self._append(b"")
            self._f.seek(0)
            self._f.write(
                SIGNATURE
                + struct.pack("<BBBBBBBBHHI", 0, 0, 0, 0, 0, OFFSET, OFFSET,
                              0, LEAF_K, INTERNAL_K, 0)
                + struct.pack("<QQQQ", 0, UNDEFINED, eof, UNDEFINED)
                + _entry(0, header, (btree, heap)))
            self._f.close()
            self._f = None
            if self._src is not None:
                self._src.close()
            os.replace(self._tmp, self.path)
        except BaseException:
            self.abort()
            raise

    def abort(self):
        """Stop without touching the target: remove the partial file."""
        if self._f is not None:
            self._f.close()
            self._f = None
        if self._src is not None:
            self._src.close()
        if os.path.exists(self._tmp):
            os.remove(self._tmp)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            self.close()
        else:
            self.abort()


def write_hdf5(path, datasets):
    """Write ``datasets`` ({``/``-separated name: numpy array}) as a new
    HDF5 file at ``path``, each dataset contiguous; returns ``path``."""
    with Hdf5Writer(path) as w:
        for name, arr in datasets.items():
            w.add(name, arr, gzip=None)
    return path
