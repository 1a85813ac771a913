"""The port's streaming HDF5 writer (``rcvpose_tpu_torch.data.hdf5_write.
Hdf5Writer``) on the CPU, held against h5py.

Files it writes, contiguous or gzip-chunked, read back equal in h5py and
in the port's own reader (``readers.Hdf5File``); its gzip-9 files are
within 5% of h5py's size on the same arrays; its ``"a"`` mode keeps what
h5py wrote (chunk bytes, filter masks and offsets as stored, chunk
B-trees of several levels, attributes, empty groups), deletes and
replaces as h5py's does, refuses what the reader refuses by name, and
leaves the target untouched when it fails.
"""

import os

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from rcvpose_tpu_torch.data import hdf5_write, readers

DTYPES = (np.uint8, np.int16, np.uint16, np.int32, np.int64, np.float16,
          np.float32, np.float64)


def _random(rng, dtype, shape):
    if np.dtype(dtype).kind == "f":
        return rng.normal(size=shape).astype(dtype)
    info = np.iinfo(dtype)
    return rng.integers(max(info.min, -1000), min(info.max, 1000),
                        size=shape).astype(dtype)


def _check(path, data):
    """h5py and the port's reader read ``data`` back, dtypes and shapes
    too."""
    import h5py

    with h5py.File(path, "r") as f, readers.Hdf5File(path) as g:
        for name, arr in data.items():
            for got in (np.array(f[name]), np.array(g[name])):
                assert got.dtype == arr.dtype and got.shape == arr.shape, name
                np.testing.assert_array_equal(got, arr)


@pytest.mark.parametrize("gzip", [None, 0, 9])
def test_nested_groups_of_many_names_read_back(tmp_path, gzip):
    """Groups of 1, 9 and 40 members (one, two and five symbol-table
    nodes), three levels deep, every dtype, scalars and empty arrays."""
    rng = np.random.default_rng(0)
    data = {"top": _random(rng, np.float32, (5, 7))}
    for i in range(9):
        data[f"a/nine/{i}"] = _random(rng, DTYPES[i % len(DTYPES)],
                                      (3, i + 1))
    for i in range(40):
        data[f"a/b/forty/x{i:02d}"] = _random(rng, DTYPES[i % len(DTYPES)],
                                              (2, 3, 4)[:i % 4])
    data["a/b/empty"] = np.zeros((0, 3), np.int16)
    path = str(tmp_path / "f.hdf5")
    with hdf5_write.Hdf5Writer(path) as w:
        for name, arr in data.items():
            w.add(name, arr, gzip=gzip)
    _check(path, data)
    import h5py

    with h5py.File(path, "r") as f:
        want = "gzip" if gzip is not None else None
        assert f["a/b/forty/x03"].compression == want
        if gzip is not None:
            assert f["top"].chunks == (5, 7)
            assert f["top"].compression_opts == gzip


_NAME = st.text(alphabet="abcXYZ019_-.+ ", min_size=1, max_size=6).filter(
    lambda s: s != ".")


@settings(max_examples=20, deadline=None)
@given(st.dictionaries(
    st.lists(_NAME, min_size=1, max_size=3).map("/".join),
    st.tuples(st.sampled_from(DTYPES),
              st.lists(st.integers(1, 5), min_size=0, max_size=3),
              st.integers(0, 2 ** 32 - 1), st.sampled_from([None, 1, 9])),
    min_size=1, max_size=30))
def test_any_names_dtypes_and_shapes_round_trip(tmp_path_factory, spec):
    names = sorted(spec)
    prefixes = {"/".join(n.split("/")[:i]) for n in names
                for i in range(1, n.count("/") + 1)}
    data, gz = {}, {}
    for name in names:
        if name in prefixes:     # a name that is a group on another's path
            continue
        dtype, shape, seed, gz[name] = spec[name]
        data[name] = _random(np.random.default_rng(seed), dtype, shape)
    path = str(tmp_path_factory.mktemp("h") / "f.hdf5")
    with hdf5_write.Hdf5Writer(path) as w:
        for name, arr in data.items():
            w.add(name, arr, gzip=gz[name])
    _check(path, data)


def _ycb_like(rng, frames, h=480, w=640):
    """YCB-shaped arrays: a blocky colour image and three radial maps
    that are zero outside a disk, as the label generator writes them."""
    data = {}
    yy, xx = np.mgrid[:h, :w]
    for i in range(frames):
        coarse = rng.integers(0, 256, size=(h // 16, w // 16, 3))
        data[f"JPEGImages/0000_{i:06d}"] = np.clip(
            np.kron(coarse, np.ones((16, 16, 1)))
            + rng.normal(0, 4, size=(h, w, 3)), 0, 255).astype(np.uint8)
        disk = (yy - h / 2) ** 2 + (xx - w / 2) ** 2 < (h / 4) ** 2
        for k in (1, 2, 3):
            data[f"3Dradius_pt{k}_dm/0000_{i:06d}"] = np.where(
                disk, rng.uniform(1.0, 3.0, size=(h, w)), 0).astype(
                np.float32)
    return data


def test_gzip9_files_within_5_percent_of_h5py(tmp_path):
    import h5py

    data = _ycb_like(np.random.default_rng(3), frames=2)
    ours, theirs = str(tmp_path / "ours.hdf5"), str(tmp_path / "h5py.hdf5")
    with hdf5_write.Hdf5Writer(ours) as w:
        for name, arr in data.items():
            w.add(name, arr, gzip=9)
    with h5py.File(theirs, "w") as f:
        for name, arr in data.items():
            f.create_dataset(name, data=arr, compression="gzip",
                             compression_opts=9)
    size, ref = os.path.getsize(ours), os.path.getsize(theirs)
    raw = sum(a.nbytes for a in data.values())
    print(f"gzip 9: port {size} B, h5py {ref} B, raw {raw} B")
    assert abs(size - ref) <= 0.05 * ref
    assert size < raw / 2
    _check(ours, data)


def _chunks(reader, entry):
    """A chunked dataset's stored chunks (bytes, filter mask, offset), in
    offset order (a chunk B-tree's walk order depends on its shape)."""
    return sorted((bytes(reader.data[a:a + s]), m, o)
                  for a, s, m, o in reader.stored(entry)[2])


def test_append_carries_h5py_chunks_btrees_and_attributes(tmp_path):
    """A file h5py wrote: a dataset of 900 chunks (a chunk B-tree of two
    levels), one without filters, a contiguous one with an attribute, an
    empty group and a root attribute. Appending keeps them as stored,
    deletes a group with its members, and replaces a dataset."""
    import h5py

    rng = np.random.default_rng(4)
    path = str(tmp_path / "f.hdf5")
    big = rng.normal(size=(300, 300)).astype(np.float32)
    plain = rng.integers(0, 9, size=(40, 30)).astype(np.uint8)
    with h5py.File(path, "w") as f:
        f.create_dataset("g/big", data=big, chunks=(10, 10),
                         compression="gzip", compression_opts=4)
        f.create_dataset("g/plain", data=plain, chunks=(7, 11))
        f.create_dataset("cont", data=np.arange(10))
        f["cont"].attrs["a"] = np.int32(5)
        f.attrs["title"] = np.float64(2.5)
        f.create_group("empty")
        f.create_dataset("gone/x", data=np.ones(3))
        f.create_dataset("swap", data=np.ones(4))
    with readers.Hdf5File(path) as f:
        r = f._reader
        before = {n: _chunks(r, f[n]._entry) for n in ("g/big", "g/plain")}
    assert len(before["g/big"]) == 900
    with hdf5_write.Hdf5Writer(path, "a") as w:
        assert "g/big" in w and "empty" in w and "g" in w
        assert "nothing" not in w
        del w["gone"]
        assert "gone/x" not in w
        with pytest.raises(ValueError, match="written twice"):
            w.add("swap", np.zeros(2))
        del w["swap"]
        w.add("swap", np.zeros(2, np.int64))
        w.add("new/y", np.arange(6, dtype=np.float64).reshape(2, 3))
        assert "new" in w and "new/y" in w
    _check(path, {"g/big": big, "g/plain": plain, "cont": np.arange(10),
                  "swap": np.zeros(2, np.int64),
                  "new/y": np.arange(6, dtype=np.float64).reshape(2, 3)})
    with h5py.File(path, "r") as f:
        assert sorted(f.keys()) == ["cont", "empty", "g", "new", "swap"]
        assert f["cont"].attrs["a"] == 5 and f.attrs["title"] == 2.5
        assert f["g/big"].chunks == (10, 10)
        assert f["g/big"].compression_opts == 4
        assert f["g/plain"].chunks == (7, 11)
    with readers.Hdf5File(path) as f:
        r = f._reader
        for n, chunks in before.items():
            assert _chunks(r, f[n]._entry) == chunks


def test_append_refuses_what_the_reader_refuses(tmp_path):
    """A filter other than deflate (h5py's shuffle) is refused by name
    when the file is opened, and the target stays as it was."""
    import h5py

    path = str(tmp_path / "f.hdf5")
    with h5py.File(path, "w") as f:
        f.create_dataset("s", data=np.arange(100), chunks=(10,),
                         shuffle=True, compression="gzip")
    with open(path, "rb") as fh:
        was = fh.read()
    with pytest.raises(ValueError, match="filter 2"):
        hdf5_write.Hdf5Writer(path, "a")
    with open(path, "rb") as fh:
        assert fh.read() == was
    assert os.listdir(tmp_path) == ["f.hdf5"]


def test_a_failed_write_leaves_the_target(tmp_path):
    path = str(tmp_path / "f.hdf5")
    hdf5_write.write_hdf5(path, {"a": np.arange(3)})
    with open(path, "rb") as fh:
        was = fh.read()
    with pytest.raises(RuntimeError, match="stop"):
        with hdf5_write.Hdf5Writer(path, "a") as w:
            w.add("b", np.ones(4))
            raise RuntimeError("stop")
    with open(path, "rb") as fh:
        assert fh.read() == was
    assert os.listdir(tmp_path) == ["f.hdf5"]
    with pytest.raises(ValueError, match="mode"):
        hdf5_write.Hdf5Writer(path, "r+")
