"""Host-side dataset IO: .dpt depth, PLY models, images, masks, poses.

The port's own copy of ``rcvpose_tpu.data.readers`` (numpy only; the JAX
package's ``__init__`` pulls in JAX, so the port cannot import it). The
reference leans on Open3D (native C++) for PLY IO and PIL/NumPy for the
rest (rmap_dataset.py:10-18, 41). Open3D is not a dependency here: PLY
parsing is implemented directly (ascii + binary_little_endian vertex
elements), which is all the pipeline needs — CAD models are consumed as
point sets.

PIL is imported only by the functions that decode images (``read_image``,
``read_mask`` and the image branch of ``read_depth``); without it they raise
an ``ImportError`` that names PIL, and ``.dpt`` depth and PLY still read.
"""

from __future__ import annotations

import os

import numpy as np


def _pil_image():
    try:
        from PIL import Image
    except ImportError as exc:
        raise ImportError("decoding images needs PIL (Pillow), which is not "
                          "installed; .dpt depth and PLY models read "
                          "without it") from exc
    return Image


def read_depth(path):
    """LINEMOD .dpt (uint32 h, w header + uint16 payload) or image depth
    (reference rmap_dataset.py:10-18)."""
    path = str(path)
    if path.endswith("dpt"):
        with open(path, "rb") as f:
            h, w = np.fromfile(f, dtype=np.uint32, count=2)
            data = np.fromfile(f, dtype=np.uint16, count=int(w) * int(h))
        return data.reshape((int(h), int(w)))
    return np.asarray(_pil_image().open(path)).copy()


def read_image(path):
    """RGB uint8 (H, W, 3)."""
    return np.asarray(_pil_image().open(path).convert("RGB"))


def read_rot_tra_pose(rot_path, tra_path):
    """(3, 4) pose from the original LINEMOD ``rot*.rot`` / ``tra*.tra``
    text files, translation converted to METERS.

    The original-format files are one header line followed by whitespace-
    separated floats: 9 for the rotation, 3 for the translation **in
    centimeters** (the reference's debug-only ``linemod_pose`` reader,
    3DRadius_lm.py:59-74, returns them raw in cm). The returned pose uses
    the framework's ``pose*.npy`` convention — translation in meters — so
    a tree holding only rot/tra GT drops into ``LinemodDataset`` unchanged.
    """
    with open(rot_path) as f:
        f.readline()  # header (element counts)
        r = np.array(f.read().split(), np.float32).reshape(3, 3)
    with open(tra_path) as f:
        f.readline()
        t_cm = np.array(f.read().split(), np.float32)
    if t_cm.shape != (3,):
        raise ValueError(f"{tra_path}: expected 3 translation values, "
                         f"got {t_cm.shape}")
    return np.concatenate([r, (t_cm / 100.0)[:, None]], axis=1)


def read_mask(path):
    """First channel of the mask png as int (reference rmap_dataset.py:76)."""
    arr = np.asarray(_pil_image().open(path), dtype=np.int32)
    if arr.ndim == 3:
        arr = arr[:, :, 0]
    return arr


_PLY_DTYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def read_ply_points(path):
    """Vertex positions (N, 3) float64 from an ascii or binary-LE PLY file."""
    with open(path, "rb") as f:
        magic = f.readline().strip()
        if magic != b"ply":
            raise ValueError(f"not a PLY file: {path}")
        fmt = None
        elements = []  # list of (name, count, [(prop_name, dtype_str)])
        cur = None
        while True:
            line = f.readline()
            if not line:
                raise ValueError("unexpected EOF in PLY header")
            tokens = line.decode("ascii", "replace").strip().split()
            if not tokens:
                continue
            if tokens[0] == "format":
                fmt = tokens[1]
            elif tokens[0] == "comment":
                continue
            elif tokens[0] == "element":
                cur = (tokens[1], int(tokens[2]), [])
                elements.append(cur)
            elif tokens[0] == "property":
                if tokens[1] == "list":
                    cur[2].append((tokens[-1], ("list", tokens[2], tokens[3])))
                else:
                    cur[2].append((tokens[-1], tokens[1]))
            elif tokens[0] == "end_header":
                break

        for name, count, props in elements:
            if name != "vertex":
                continue
            if fmt == "ascii":
                rows = []
                for _ in range(count):
                    vals = f.readline().split()
                    rows.append([float(v) for v in vals[:len(props)]])
                arr = np.asarray(rows)
                cols = {p[0]: i for i, p in enumerate(props)}
                return arr[:, [cols["x"], cols["y"], cols["z"]]]
            elif fmt == "binary_little_endian":
                if any(isinstance(p[1], tuple) for p in props):
                    raise ValueError("list property in vertex element")
                dt = np.dtype([(p[0], "<" + _PLY_DTYPES[p[1]])
                               for p in props])
                arr = np.frombuffer(f.read(dt.itemsize * count), dtype=dt,
                                    count=count)
                return np.stack([arr["x"], arr["y"], arr["z"]],
                                axis=1).astype(np.float64)
            else:
                raise ValueError(f"unsupported PLY format: {fmt}")
        raise ValueError(f"no vertex element in {path}")


def oriented_bbox_corners(points):
    """8 corners of a PCA-oriented bounding box of a point set.

    Stand-in for Open3D's minimal OBB (rmap_dataset.py:47-48), used only to
    synthesize dispersed keypoints when ``Outside9.npy`` is absent. PCA axes
    are a standard approximation of the minimal-volume box.
    """
    pts = np.asarray(points, np.float64)
    c = pts.mean(axis=0)
    centered = pts - c
    cov = centered.T @ centered / len(pts)
    _, vecs = np.linalg.eigh(cov)
    proj = centered @ vecs
    lo = proj.min(axis=0)
    hi = proj.max(axis=0)
    corners = np.array([[lo[0], lo[1], lo[2]],
                        [hi[0], lo[1], lo[2]],
                        [lo[0], hi[1], lo[2]],
                        [hi[0], hi[1], lo[2]],
                        [lo[0], lo[1], hi[2]],
                        [hi[0], lo[1], hi[2]],
                        [lo[0], hi[1], hi[2]],
                        [hi[0], hi[1], hi[2]]])
    return corners @ vecs.T + c


def dispersed_keypoints(cad_points_mm):
    """Reference fallback keypoints when ``Outside9.npy`` is absent: 2x the
    oriented-bounding-box corners (rmap_dataset.py:43-51; 8 rows, indexed
    from 1 by train/eval so row 0 is effectively unused there)."""
    return oriented_bbox_corners(cad_points_mm) * 2.0


def hdf5_group_keys(path, group):
    """Member names of ``group`` (e.g. ``"JPEGImages"``) in an HDF5 file,
    in the order h5py's ``keys()`` gives them (by name).

    With h5py installed this is ``list(h5py.File(path)[group].keys())``.
    Without it, the file is read directly, as far as the names go: the
    superblock (version 0 or 1) and the symbol-table groups (v1 B-tree,
    symbol-table nodes, local name heap) that h5py writes by default. Other
    layouts (superblock 2+, link-message groups) raise ``ValueError``
    naming h5py.
    """
    with open_hdf5(path) as f:
        return list(f[group].keys())


def hdf5_dataset(path, name):
    """The dataset ``name`` (e.g. ``"3Dradius_pt1_dm/0000_000001"``) of an
    HDF5 file as a numpy array.

    With h5py installed this is ``np.array(h5py.File(path)[name])``.
    Without it, ``Hdf5File`` reads the datasets h5py writes by default:
    v1 object headers with a dataspace, a little-endian integer or float
    datatype and a version-3 layout, contiguous or chunked (v1 chunk
    B-tree) with no filter or the deflate filter (``compression="gzip"``).
    Any other layout or filter raises ``ValueError`` naming h5py.
    """
    with open_hdf5(path) as f:
        return np.array(f[name])


def open_hdf5(path):
    """A read handle on an HDF5 file: ``h5py.File(path, "r")`` when h5py
    imports, else the port's own ``Hdf5File``, which answers the same
    calls the port makes (``name in f``, ``f[name]``, ``.keys()``,
    ``np.array(dataset)``, ``close`` and ``with``)."""
    try:
        import h5py
    except ImportError:
        return Hdf5File(path)
    return h5py.File(path, "r")


class Hdf5File:
    """Read-only h5py-like view of an HDF5 file for machines without h5py
    (``_Hdf5Names``). Members are addressed by ``/``-separated paths;
    groups list and index their members, datasets turn into numpy arrays
    with ``np.array``."""

    def __init__(self, path):
        self._reader = _Hdf5Names(path)
        self._root = _Hdf5Node(self._reader, self._reader.root, "/")

    def __contains__(self, name):
        return name in self._root

    def __getitem__(self, name):
        return self._root[name]

    def keys(self):
        return self._root.keys()

    def close(self):
        self._reader.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class _Hdf5Node:
    """One group or dataset of an ``Hdf5File``."""

    def __init__(self, reader, entry, name):
        self._reader, self._entry, self.name = reader, entry, name

    def _find(self, name):
        entry = self._entry
        for part in filter(None, name.split("/")):
            members = self._reader.members(entry)
            if part not in members:
                return None
            entry = members[part]
        return entry

    def __contains__(self, name):
        return self._find(name) is not None

    def __getitem__(self, name):
        entry = self._find(name)
        if entry is None:
            raise KeyError(f"{self._reader.path}: no member {name!r}")
        return _Hdf5Node(self._reader, entry,
                         self.name.rstrip("/") + "/" + name.strip("/"))

    def keys(self):
        return list(self._reader.members(self._entry))

    def __array__(self, dtype=None, copy=None):
        arr = self._reader.dataset(self._entry)
        return arr if dtype is None else arr.astype(dtype)


class _Hdf5Names:
    """Groups and datasets of an HDF5 file as h5py writes them by default
    (format specification 3.0: superblock v0/v1, v1 B-trees of group nodes
    and of raw-data chunks, ``SNOD`` symbol-table nodes, ``HEAP`` local
    heaps, v1 object headers; dataspace, datatype, layout v3 and filter
    pipeline messages). The file is memory-mapped, not read whole."""

    def __init__(self, path):
        import mmap

        self.path = str(path)
        with open(path, "rb") as f:
            size = os.fstat(f.fileno()).st_size
            if size < 8:
                self.data = b""
                self._refuse("no HDF5 signature at offset 0")
            self.data = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        self._members = {}
        if self.data[:8] != b"\x89HDF\r\n\x1a\n":
            self._refuse("no HDF5 signature at offset 0")
        version = self.data[8]
        if version > 1:
            self._refuse(f"superblock version {version}")
        self.o, self.l = self.data[13], self.data[14]   # offset, length size
        # fixed fields, the v1 extras, then base / free-space / EOF /
        # driver addresses and the root group's symbol-table entry
        at = 24 + (4 if version == 1 else 0)
        self.base = self._uint(at, self.o)
        self.root = at + 4 * self.o

    def close(self):
        if hasattr(self.data, "close"):
            self.data.close()

    def _refuse(self, why):
        raise ValueError(f"{self.path}: {why}; reading this HDF5 layout "
                         "needs h5py")

    def _uint(self, at, size):
        return int.from_bytes(self.data[at:at + size], "little")

    def _addr(self, at):
        return self.base + self._uint(at, self.o)

    def _header(self, entry):
        return self._addr(entry + self.o)

    def _group_tables(self, entry):
        """(B-tree, local heap) addresses of the group that the symbol-table
        entry at ``entry`` names: from its scratch pad (cache type 1) or
        from the Symbol Table message of its object header; None for an
        object that is not a symbol-table group."""
        o = self.o
        if self._uint(entry + 2 * o, 4) == 1:
            scratch = entry + 2 * o + 8
            return self._addr(scratch), self._addr(scratch + o)
        for mtype, at, _ in self._messages(self._header(entry)):
            if mtype == 0x11:
                return self._addr(at), self._addr(at + o)
        return None

    def _messages(self, header):
        """(type, data offset, flags) of every message of a v1 object
        header, following continuation blocks."""
        if self.data[header] != 1:
            self._refuse(f"object header version {self.data[header]}")
        count = self._uint(header + 2, 2)
        blocks = [(header + 16, self._uint(header + 8, 4))]
        seen = 0
        while blocks and seen < count:
            at, size = blocks.pop(0)
            end = at + size
            while at + 8 <= end and seen < count:
                mtype, msize = self._uint(at, 2), self._uint(at + 2, 2)
                seen += 1
                if mtype == 0x10:   # continuation: address, length
                    blocks.append((self._addr(at + 8),
                                   self._uint(at + 8 + self.o, self.l)))
                else:
                    yield mtype, at + 8, self.data[at + 4]
                at += 8 + msize

    def _entries(self, btree, heap):
        """(name, entry offset) of every member of a group, in B-tree
        (name) order."""
        if self.data[heap:heap + 4] != b"HEAP":
            self._refuse("no local heap where the group names one")
        names = self._addr(heap + 8 + 2 * self.l)
        out = []
        nodes = [btree]
        while nodes:
            node = nodes.pop(0)
            if self.data[node:node + 4] != b"TREE" or self.data[node + 4]:
                self._refuse("no group B-tree node where one is named")
            level, used = self.data[node + 5], self._uint(node + 6, 2)
            at = node + 8 + 2 * self.o + self.l   # past the first key
            children = []
            for _ in range(used):
                children.append(self._addr(at))
                at += self.o + self.l
            if level:
                nodes[:0] = children
                continue
            for snod in children:
                if self.data[snod:snod + 4] != b"SNOD":
                    self._refuse("no symbol-table node where one is named")
                entry = snod + 8
                for _ in range(self._uint(snod + 6, 2)):
                    start = names + self._uint(entry, self.o)
                    end = self.data.find(b"\0", start)
                    out.append((bytes(self.data[start:end]).decode(), entry))
                    entry += 2 * self.o + 24
        return out

    def members(self, entry):
        """{name: entry offset} of the group at ``entry``, in name order
        (cached: a YCB class file holds thousands of frames a group)."""
        members = self._members.get(entry)
        if members is None:
            tables = self._group_tables(entry)
            if tables is None:
                if any(mtype in (0x02, 0x06) for mtype, _, _ in
                       self._messages(self._header(entry))):
                    self._refuse("a group without a symbol table (link "
                                 "messages)")
                raise KeyError(f"{self.path}: a dataset, not a group")
            members = self._members[entry] = dict(self._entries(*tables))
        return members

    # -- datasets -------------------------------------------------------

    def _dataset_messages(self, entry):
        if self._group_tables(entry) is not None:
            raise KeyError(f"{self.path}: a group, not a dataset")
        msgs = {}
        for mtype, at, flags in self._messages(self._header(entry)):
            if mtype in (0x01, 0x03, 0x08, 0x0B):
                if flags & 0x02:
                    self._refuse(f"a shared message of type {mtype:#x}")
                msgs[mtype] = at
        for mtype in (0x01, 0x03, 0x08):
            if mtype not in msgs:
                self._refuse(f"a dataset without message {mtype:#x}")
        return msgs

    def _dataspace(self, at):
        version, rank, flags = self.data[at], self.data[at + 1], \
            self.data[at + 2]
        if version == 1:
            dims = at + 8
        elif version == 2:
            if self.data[at + 3] == 2:
                self._refuse("a null dataspace")
            dims = at + 4
        else:
            self._refuse(f"dataspace message version {version}")
        return tuple(self._uint(dims + i * self.l, self.l)
                     for i in range(rank))

    def _datatype(self, at):
        cls, version = self.data[at] & 0x0F, self.data[at] >> 4
        bits, size = self.data[at + 1], self._uint(at + 4, 4)
        if bits & 0x01:
            self._refuse("a big-endian datatype")
        if cls == 0 and size in (1, 2, 4, 8):        # fixed point
            return np.dtype(f"<{'i' if bits & 0x08 else 'u'}{size}")
        if cls == 1 and size in (2, 4, 8) and not bits & 0x40:
            return np.dtype(f"<f{size}")
        self._refuse(f"datatype class {cls} (version {version}) of "
                     f"{size} bytes")

    def _filters(self, at):
        """Filter ids of a filter pipeline message, in pipeline order."""
        if at is None:
            return []
        version, n = self.data[at], self.data[at + 1]
        if version not in (1, 2):
            self._refuse(f"filter pipeline message version {version}")
        pos = at + (8 if version == 1 else 2)
        ids = []
        for _ in range(n):
            fid = self._uint(pos, 2)
            name_len = 0
            if version == 1 or fid >= 256:
                name_len = self._uint(pos + 2, 2)
                pos += 2
            nvalues = self._uint(pos + 4, 2)
            pos += 6
            pos += (name_len + 7) // 8 * 8 if version == 1 else name_len
            pos += 4 * nvalues + (4 if version == 1 and nvalues % 2 else 0)
            if fid != 1:
                self._refuse(f"filter {fid} (only deflate, id 1, is read)")
            ids.append(fid)
        return ids

    def dataset(self, entry):
        """The dataset at symbol-table entry ``entry`` as a numpy array."""
        import zlib

        shape, dtype, filters, storage = self._storage(entry)
        count = int(np.prod(shape, dtype=np.int64))
        if storage[0] == "contiguous":
            _, start, size = storage
            raw = self.data[start:start + size]
            return np.frombuffer(raw, dtype, count).reshape(shape).copy()
        _, dims, records = storage
        chunk = dims[:-1]
        out = np.zeros(shape, dtype)
        for child, size, mask, offset in records:
            raw = bytes(self.data[child:child + size])
            for i in reversed(range(len(filters))):
                if not mask >> i & 1:
                    raw = zlib.decompress(raw)
            block = np.frombuffer(raw, dtype,
                                  int(np.prod(chunk))).reshape(chunk)
            dst = tuple(slice(o, min(o + c, n))
                        for o, c, n in zip(offset, chunk, shape))
            out[dst] = block[tuple(slice(0, s.stop - s.start)
                                   for s in dst)]
        return out

    def stored(self, entry):
        """How the dataset at ``entry`` is stored, for a copy that keeps
        its bytes: ``("contiguous", address, size)`` or ``("chunked",
        chunk dimensions with the element size last, [(address, size,
        filter mask, offset)])``. It checks the dataspace, datatype,
        filters and layout as ``dataset`` does, so what that refuses
        stays refused."""
        return self._storage(entry)[3]

    def _storage(self, entry):
        """(shape, dtype, filter ids, ``stored``'s tuple) of a dataset."""
        msgs = self._dataset_messages(entry)
        shape = self._dataspace(msgs[0x01])
        dtype = self._datatype(msgs[0x03])
        filters = self._filters(msgs.get(0x0B))
        at = msgs[0x08]
        if self.data[at] != 3:
            self._refuse(f"layout message version {self.data[at]}")
        layout = self.data[at + 1]
        if layout == 1:                                  # contiguous
            size = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
            if not size:         # HDF5 allocates nothing for no elements
                return shape, dtype, filters, ("contiguous", 0, 0)
            if self._uint(at + 2, self.o) == (1 << (8 * self.o)) - 1:
                self._refuse("a dataset with no storage allocated")
            return shape, dtype, filters, ("contiguous", self._addr(at + 2),
                                           size)
        if layout != 2:
            self._refuse(f"layout class {layout}")
        dims = tuple(self._uint(at + 3 + self.o + 4 * i, 4)
                     for i in range(self.data[at + 2]))
        if len(dims) != len(shape) + 1:
            self._refuse("a chunk rank that is not the dataspace's")
        return shape, dtype, filters, ("chunked", dims,
                                       list(self._chunk_records(at)))

    def _chunk_records(self, layout):
        """(address, size, filter mask, offset) of every stored chunk of
        the chunked layout message at ``layout``, walking its v1 chunk
        B-tree; the offset has one entry a dimension plus the datatype's
        (always 0). Nothing when no chunk was ever written."""
        dims = self.data[layout + 2]
        if self._uint(layout + 3, self.o) == (1 << (8 * self.o)) - 1:
            return
        key_size = 8 + 8 * dims
        nodes = [self._addr(layout + 3)]
        while nodes:
            node = nodes.pop()
            if self.data[node:node + 4] != b"TREE" or self.data[node + 4] != 1:
                self._refuse("no chunk B-tree node where one is named")
            level, used = self.data[node + 5], self._uint(node + 6, 2)
            pos = node + 8 + 2 * self.o
            for _ in range(used):
                size, mask = self._uint(pos, 4), self._uint(pos + 4, 4)
                offset = tuple(self._uint(pos + 8 + 8 * i, 8)
                               for i in range(dims))
                child = self._addr(pos + key_size)
                pos += key_size + self.o
                if level:
                    nodes.append(child)
                else:
                    yield child, size, mask, offset

    # -- what a writer carries over as stored ---------------------------

    # messages carried verbatim: dataspace, datatype, fill values (old and
    # new), filter pipeline, attribute, comment, modification times (old
    # and new); 0x00 (NIL) and 0x10 (continuation) are the header's own
    _CARRIED = (0x01, 0x03, 0x04, 0x05, 0x0B, 0x0C, 0x0D, 0x0E, 0x12)

    def walk(self, entry=None, prefix=""):
        """(name, entry, is group) of every object under the group at
        ``entry`` (the root when None), depth first in name order, names
        ``/``-separated from that group."""
        entry = self.root if entry is None else entry
        for name, child in self.members(entry).items():
            path = f"{prefix}{name}"
            group = self._group_tables(child) is not None
            yield path, child, group
            if group:
                yield from self.walk(child, path + "/")

    def object_messages(self, entry):
        """The messages of the object at ``entry`` that a copy keeps as
        they are, [(type, flags, bytes)], in header order: everything but
        the layout and symbol-table messages, which a writer makes anew.
        A message this reader does not know, a shared one, or an attribute
        whose datatype points outside its message (variable length,
        reference, compound) raises naming it."""
        out = []
        for mtype, at, flags in self._messages(self._header(entry)):
            if mtype in (0x00, 0x08, 0x11):
                continue
            if mtype not in self._CARRIED:
                self._refuse(f"object header message type {mtype:#x}")
            if flags & 0x02:
                self._refuse(f"a shared message of type {mtype:#x}")
            raw = bytes(self.data[at:at + self._uint(at - 6, 2)])
            if mtype == 0x0C:
                self._attribute_datatype(raw)
            out.append((mtype, flags, raw))
        return out

    def _attribute_datatype(self, raw):
        """Refuse an attribute message (versions 1-3) whose datatype class
        refers to data outside the message."""
        version, name_size, type_size = raw[0], \
            int.from_bytes(raw[2:4], "little"), \
            int.from_bytes(raw[4:6], "little")
        if version == 1:
            at = 8 + (name_size + 7) // 8 * 8
        elif version in (2, 3):
            at = 8 + (version == 3) + name_size
        else:
            self._refuse(f"attribute message version {version}")
        cls = raw[at] & 0x0F if type_size else -1
        if cls in (6, 7, 9):
            self._refuse(f"an attribute of datatype class {cls} (compound, "
                         "reference or variable length)")
