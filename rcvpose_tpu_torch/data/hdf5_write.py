"""A small HDF5 writer for machines without h5py.

It writes the layout the port's own reader (``readers.Hdf5File``) reads
and h5py writes by default (HDF5 file format specification 3.0):

- a version-0 superblock (8-byte offsets and lengths, group leaf node K 4,
  group internal node K 16);
- symbol-table groups: a local heap of names (``HEAP``), symbol-table
  nodes (``SNOD``, up to 2 x leaf K = 8 entries each) and a version-1
  B-tree of group nodes (``TREE``, up to 2 x internal K = 32 children a
  node, as many levels as the names need), names in byte order;
- version-1 object headers: a symbol-table message for a group; for a
  dataset a simple dataspace, a little-endian fixed-point or IEEE float
  datatype and a version-3 contiguous layout, with no filter.

Datasets are numpy arrays of (u)int8/16/32/64 or float16/32/64, addressed
by ``/``-separated names; groups on the way are made as needed.

    hdf5_write.write_hdf5(path, {"JPEGImages/0000_000001": image})
"""

from __future__ import annotations

import struct

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
OFFSET = 8                  # size of offsets and of lengths
UNDEFINED = (1 << 64) - 1   # the undefined address
LEAF_K = 4                  # group leaf node K: 2K entries a SNOD
INTERNAL_K = 16             # group internal node K: 2K children a TREE
SUPERBLOCK_SIZE = 96        # v0 fields + the root's symbol-table entry
ENTRY_SIZE = 2 * OFFSET + 24
HEAP_FREE_NULL = 1          # "no free block" in a local heap's free list

# object header message types
_DATASPACE, _DATATYPE, _LAYOUT, _SYMBOL_TABLE = 0x01, 0x03, 0x08, 0x11
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


class _Buffer:
    """The file's bytes; objects are appended 8-byte aligned and their
    addresses returned."""

    def __init__(self):
        self.data = bytearray(SUPERBLOCK_SIZE)

    def append(self, raw):
        at = _pad8(len(self.data))
        self.data.extend(b"\0" * (at - len(self.data)))
        self.data.extend(raw)
        return at


def _object_header(buf, messages):
    """A version-1 object header holding ``messages`` [(type, data,
    flags)], each padded to 8 bytes; returns its address."""
    body = b""
    for mtype, data, flags in messages:
        data = data + b"\0" * (_pad8(len(data)) - len(data))
        body += struct.pack("<HHB3x", mtype, len(data), flags) + data
    prefix = struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body))
    return buf.append(prefix + body)


def _entry(name_offset, header, group_tables=None):
    """A symbol-table entry: cache type 1 with the group's (B-tree, heap)
    addresses in the scratch pad, else 0."""
    if group_tables is None:
        return struct.pack("<QQII16x", name_offset, header, 0, 0)
    return struct.pack("<QQIIQQ", name_offset, header, 1, 0, *group_tables)


def _btree_level(buf, children, level):
    """Write one level of group B-tree nodes over ``children`` [(address,
    left key, right key)] (name offsets as keys), each node with up to
    2 x INTERNAL_K children and sibling links. Returns the nodes as
    [(address, left key, right key)]."""
    per = 2 * INTERNAL_K
    chunks = [children[i:i + per] for i in range(0, len(children), per)]
    chunks = chunks or [[]]
    size = 8 + 2 * OFFSET + (per + 1) * OFFSET + per * OFFSET
    start = _pad8(len(buf.data))
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
        if buf.append(raw) != addrs[i]:
            raise AssertionError("hdf5_write: B-tree nodes not contiguous")
        nodes.append((addrs[i], left_key,
                      chunk[-1][2] if chunk else left_key))
    return nodes


def _write_group(buf, members):
    """Write a group's members ({name: array or dict}), its local heap,
    symbol-table nodes and B-tree, and its object header. Returns (header
    address, B-tree address, heap address)."""
    names = sorted(members, key=lambda s: s.encode())
    entries = []
    heap_data = bytearray(8)       # offset 0: the empty name
    for name in names:
        offset = len(heap_data)
        raw = name.encode()
        heap_data.extend(raw + b"\0" * (_pad8(len(raw) + 1) - len(raw)))
        value = members[name]
        if isinstance(value, dict):
            header, btree, heap = _write_group(buf, value)
            entries.append((offset, _entry(offset, header, (btree, heap))))
        else:
            entries.append((offset,
                            _entry(offset, _write_dataset(buf, value))))
    heap_header = struct.pack("<4sB3xQQQ", b"HEAP", 0, len(heap_data),
                              HEAP_FREE_NULL, 0)
    heap = buf.append(heap_header)
    data_at = buf.append(bytes(heap_data))
    buf.data[heap + 24:heap + 32] = struct.pack("<Q", data_at)

    per = 2 * LEAF_K
    leaves = []
    prev_key = 0
    for i in range(0, len(entries), per):
        chunk = entries[i:i + per]
        raw = struct.pack("<4sBBH", b"SNOD", 1, 0, len(chunk))
        raw += b"".join(e for _, e in chunk)
        raw += b"\0" * (8 + per * ENTRY_SIZE - len(raw))
        leaves.append((buf.append(raw), prev_key, chunk[-1][0]))
        prev_key = chunk[-1][0]
    level, nodes = 0, _btree_level(buf, leaves, 0)
    while len(nodes) > 1:
        level += 1
        nodes = _btree_level(buf, nodes, level)
    btree = nodes[0][0]
    header = _object_header(
        buf, [(_SYMBOL_TABLE, struct.pack("<QQ", btree, heap), 0)])
    return header, btree, heap


def _write_dataset(buf, arr):
    """Write ``arr``'s bytes and its object header; returns the header's
    address."""
    dtype = arr.dtype.newbyteorder("<")
    raw = arr.astype(dtype, copy=False).tobytes()   # C order
    data_at = buf.append(raw)
    space = struct.pack("<BBB5x", 1, arr.ndim, 0) + b"".join(
        struct.pack("<Q", n) for n in arr.shape)
    layout = struct.pack("<BBQQ", 3, 1, data_at, len(raw))
    return _object_header(buf, [(_DATASPACE, space, 0),
                                (_DATATYPE, _datatype(dtype), 1),
                                (_LAYOUT, layout, 0)])


def _tree(datasets):
    """{name: array} with ``/``-separated names -> nested dicts."""
    root = {}
    for name, arr in datasets.items():
        parts = [p for p in name.split("/") if p]
        if not parts or any(p == "." or "\0" in p for p in parts):
            raise ValueError(f"hdf5_write: bad dataset name {name!r}")
        node = root
        for part in parts[:-1]:
            node = node.setdefault(part, {})
            if not isinstance(node, dict):
                raise ValueError(f"hdf5_write: {name!r} passes through a "
                                 "dataset")
        if parts[-1] in node:
            raise ValueError(f"hdf5_write: {name!r} written twice")
        node[parts[-1]] = np.asarray(arr)
    return root


def write_hdf5(path, datasets):
    """Write ``datasets`` ({``/``-separated name: numpy array}) as a new
    HDF5 file at ``path``; returns ``path``."""
    buf = _Buffer()
    header, btree, heap = _write_group(buf, _tree(datasets))
    eof = len(buf.data)
    buf.data[:SUPERBLOCK_SIZE] = (
        SIGNATURE
        + struct.pack("<BBBBBBBBHHI", 0, 0, 0, 0, 0, OFFSET, OFFSET, 0,
                      LEAF_K, INTERNAL_K, 0)
        + struct.pack("<QQQQ", 0, UNDEFINED, eof, UNDEFINED)
        + _entry(0, header, (btree, heap)))
    with open(path, "wb") as f:
        f.write(bytes(buf.data))
    return path
