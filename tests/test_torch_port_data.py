"""The port's data path against the JAX package's, on the CPU.

Both packages read the same fixture trees (``tests/test_data.py``'s
48x64 LINEMOD tree, a YCB HDF5 in the layout of ``tests/test_ycb_data.py``
with three keypoint groups). Raw arrays must be equal; the loaders must
read the same frames in the same order and give the same labels: images
within rtol 1e-6 / atol 1e-6, radii within 1e-5 dm (rtol 1e-6), sem maps
equal, as ``test_torch_port_train.py::test_make_sample_matches_jax``.
"""

import os
import re
import sys
from pathlib import Path

import numpy as np
import pytest

from rcvpose_tpu import native as jax_native
from rcvpose_tpu.data import dataset as jax_dataset
from rcvpose_tpu.data import loader as jax_loader
from rcvpose_tpu.data import readers as jax_readers
from rcvpose_tpu_torch import native
from rcvpose_tpu_torch.data import dataset, loader, readers
from tests.test_data import make_linemod_tree, write_dpt

K = np.array([[60.0, 0, 32], [0, 60.0, 24], [0, 0, 1]])
YCB_IDS = ["0001_000001", "0001_000002", "0001_000003", "0002_000001",
           "0002_000002"]


def make_ycb_train_tree(root, rng, h=32, w=48, heads=3):
    """``<root>/toy/Split/val.txt`` and ``<root>/toy.hdf5`` with
    ``JPEGImages`` and ``3Dradius_pt1..heads_dm`` per frame (gzip), as
    h5py writes by default."""
    import h5py

    os.makedirs(os.path.join(root, "toy", "Split"))
    with open(os.path.join(root, "toy", "Split", "val.txt"), "w") as f:
        f.write("\n".join(YCB_IDS) + "\n")
    with h5py.File(os.path.join(root, "toy.hdf5"), "w") as f:
        for i in YCB_IDS:
            for kp in range(1, heads + 1):
                radial = np.zeros((h, w), np.float32)
                radial[8:20, 10:30] = rng.uniform(0.5, 12.0, size=(12, 20))
                f.create_dataset(f"3Dradius_pt{kp}_dm/{i}", data=radial,
                                 compression="gzip")
            img = (rng.uniform(size=(h, w, 3)) * 255).astype(np.uint8)
            f.create_dataset(f"JPEGImages/{i}", data=img, compression="gzip")
    return str(root)


@pytest.fixture
def lm_root(tmp_path):
    return make_linemod_tree(tmp_path, np.random.default_rng(0), n_frames=5)


@pytest.fixture
def ycb_root(tmp_path):
    return make_ycb_train_tree(tmp_path, np.random.default_rng(1))


def _same_sample(got, want):
    assert got.keys() == want.keys()
    for key in want:
        if key == "img_id":
            assert got[key] == want[key]
        else:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
            assert np.asarray(got[key]).dtype == np.asarray(want[key]).dtype


def test_linemod_dataset_matches_jax(lm_root):
    port = dataset.LinemodDataset(lm_root, "toy", kpt_num=2)
    ref = jax_dataset.LinemodDataset(lm_root, "toy", kpt_num=2)
    assert port.ids == ref.ids and len(port) == 5
    np.testing.assert_array_equal(port.keypoints, ref.keypoints)
    assert port.max_radii_dm == ref.max_radii_dm
    np.testing.assert_array_equal(port.max_radii_for([1, 2, 3]),
                                  ref.max_radii_for([1, 2, 3]))
    for i in range(len(port)):
        _same_sample(port.raw(i), ref.raw(i))
    for got, want in zip(port.raw_batch([4, 0, 2]), ref.raw_batch([4, 0, 2])):
        _same_sample(got, want)


def test_linemod_dataset_writes_missing_keypoints_as_jax(tmp_path):
    roots = [make_linemod_tree(tmp_path / name, np.random.default_rng(2))
             for name in ("a", "b")]
    for root in roots:
        os.remove(os.path.join(root, "toy", "Outside9.npy"))
    port = dataset.LinemodDataset(roots[0], "toy")
    ref = jax_dataset.LinemodDataset(roots[1], "toy")
    np.testing.assert_array_equal(port.keypoints, ref.keypoints)
    np.testing.assert_array_equal(
        np.load(os.path.join(roots[0], "toy", "Outside9.npy")),
        np.load(os.path.join(roots[1], "toy", "Outside9.npy")))


@pytest.mark.parametrize("h5py_present", [True, False])
def test_ycb_dataset_matches_jax(ycb_root, monkeypatch, h5py_present):
    """``raw`` / ``raw_multi`` equal the JAX dataset's arrays, through h5py
    and through the port's own HDF5 reader with h5py hidden."""
    ref = jax_dataset.YcbDataset(ycb_root, "toy", kpt_num=2)
    want = [(ref.raw(i), ref.raw_multi(i, 3)) for i in range(len(ref))]
    ref.close()
    if not h5py_present:
        monkeypatch.setitem(sys.modules, "h5py", None)
    port = dataset.YcbDataset(ycb_root, "toy", kpt_num=2)
    for i, (raw, multi) in enumerate(want):
        _same_sample(port.raw(i), raw)
        _same_sample(port.raw_multi(i, 3), multi)
    assert isinstance(port._h5, readers.Hdf5File) != h5py_present
    port.close()


def _jax_batches(ld, epoch, start):
    return [{k: np.asarray(v) for k, v in b.items()}
            for b in ld.batches(epoch, start)]


def _assert_batches(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["image"].numpy(), w["image"], rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(g["radial"].numpy(), w["radial"],
                                   rtol=1e-6, atol=1e-5)
        np.testing.assert_array_equal(g["sem"].numpy(), w["sem"])


def _counting(cls, reads):
    """``cls`` recording the frame indices of each read call."""
    def counted(name):
        def read(self, index, *args):
            reads.append([int(i) for i in np.atleast_1d(index)])
            return getattr(cls, name)(self, index, *args)
        return read
    return type("Counting", (cls,), {name: counted(name) for name in
                                     ("raw", "raw_batch", "raw_multi")
                                     if hasattr(cls, name)})


@pytest.mark.parametrize("name,heads", [("lm", 1), ("lm", 3), ("ycb", 1),
                                        ("ycb", 3)])
def test_loaders_read_the_same_frames_and_labels(lm_root, ycb_root, name,
                                                 heads):
    """Same frame order over several (seed, epoch) pairs, two shards and a
    mid-epoch start; same labels (single- and multi-head; YCB through the
    precomputed route with ``ycb_clip``)."""
    if name == "lm":
        root, pcls, jcls = lm_root, dataset.LinemodDataset, \
            jax_dataset.LinemodDataset
    else:
        root, pcls, jcls = ycb_root, dataset.YcbDataset, \
            jax_dataset.YcbDataset
    reads = {"port": [], "jax": []}
    kw = dict(batch_size=2, ycb_clip=name == "ycb", kpt_heads=heads)
    for seed, epoch, rank, start in [(0, 0, 0, 0), (3, 1, 0, 1),
                                     (7, 2, 1, 0)]:
        count = 2 if rank else 1
        pl = loader.BatchLoader(_counting(pcls, reads["port"])(root, "toy"),
                                K, seed=seed, shard_rank=rank,
                                shard_count=count, device="cpu", **kw)
        jl = jax_loader.BatchLoader(_counting(jcls, reads["jax"])(root, "toy"),
                                    K, seed=seed, shard_rank=rank,
                                    shard_count=count, **kw)
        assert len(pl) == len(jl)
        np.testing.assert_array_equal(pl._index_order(epoch),
                                      jl._index_order(epoch))
        _assert_batches(list(pl.batches(epoch, start)),
                        _jax_batches(jl, epoch, start))
        assert reads["port"] == reads["jax"]
    # bare iteration walks the epochs as the JAX loader does
    pl = loader.BatchLoader(pcls(root, "toy"), K, seed=5, device="cpu", **kw)
    jl = jax_loader.BatchLoader(jcls(root, "toy"), K, seed=5, **kw)
    for _ in range(2):
        _assert_batches(list(pl), [{k: np.asarray(v) for k, v in b.items()}
                                   for b in jl])
    if heads > 1:
        assert pl.batches(0).__next__()["radial"].shape[-1] == heads


def test_make_loaders_shards_by_the_process_group(lm_root, monkeypatch):
    """``make_loaders`` takes its train shard from ``torch.distributed``
    when a process group is up (else rank 0 of 1); the val loader stays
    full-set."""
    import torch.distributed as dist

    from rcvpose_tpu_torch.config import Config

    cfg = Config(root_dataset=lm_root, class_name="toy", batch_size=1)
    train, val = loader.make_loaders(cfg, device="cpu",
                                     progress=lambda *_: None)
    assert (train.shard_rank, train.shard_count, len(train)) == (0, 1, 5)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda: 1)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    train, val = loader.make_loaders(cfg, device="cpu",
                                     progress=lambda *_: None)
    assert (train.shard_rank, train.shard_count, len(train)) == (1, 2, 2)
    assert (val.shard_count, len(val)) == (1, 5)
    jtrain, _ = jax_loader.make_loaders(cfg, shard_rank=1, shard_count=2)
    np.testing.assert_array_equal(train._index_order(3),
                                  jtrain._index_order(3))


def test_loader_without_drop_last_and_shapes(lm_root):
    pl = loader.BatchLoader(dataset.LinemodDataset(lm_root, "toy"), K,
                            batch_size=2, shuffle=False, drop_last=False,
                            device="cpu")
    got = list(pl.batches(0))
    assert len(pl) == 3 and [b["image"].shape[0] for b in got] == [2, 2, 1]
    assert got[0]["radial"].shape == (2, 48, 64)
    assert pl.stats["batches"] == 3 and pl.stats["wait_s"] >= 0.0
    with pytest.raises(ValueError, match="shard_rank"):
        loader.BatchLoader(dataset.LinemodDataset(lm_root, "toy"), K, 1,
                           shard_rank=2, shard_count=2, device="cpu")


class _Broken:
    """A dataset whose third frame fails to read."""

    def __init__(self, inner):
        self.inner = inner
        self.kpt, self.max_radii_dm = inner.kpt, inner.max_radii_dm

    def __len__(self):
        return len(self.inner)

    def raw(self, index):
        if index == 2:
            raise OSError("frame 2 is unreadable")
        return self.inner.raw(index)


def test_producer_error_reraises_in_the_port(lm_root):
    """A read that raises in the producer thread re-raises in the
    consumer (the port's deliberate divergence)."""
    ds = _Broken(dataset.LinemodDataset(lm_root, "toy"))
    pl = loader.BatchLoader(ds, K, batch_size=1, shuffle=False, device="cpu")
    got = []
    with pytest.raises(OSError, match="frame 2 is unreadable"):
        for b in pl.batches(0):
            got.append(b)
    assert len(got) == 2


def test_jax_loader_ends_the_epoch_short_on_a_producer_error(lm_root):
    """The reference behaviour the port diverges from: the JAX producer's
    ``try/finally`` enqueues the stop marker, so the epoch ends after the
    frames read before the error, with no exception."""
    ds = _Broken(jax_dataset.LinemodDataset(lm_root, "toy"))
    jl = jax_loader.BatchLoader(ds, K, batch_size=1, shuffle=False)
    assert len(jl) == 5
    assert len(list(jl.batches(0))) == 2


@pytest.mark.skipif(not native.available(), reason="no g++ toolchain")
def test_native_reader_matches_numpy_and_jax(tmp_path):
    rng = np.random.default_rng(3)
    paths, deps = [], []
    for i in range(5):
        d = rng.integers(0, 65535, size=(16 + i, 24)).astype(np.uint16)
        p = str(tmp_path / f"d{i}.dpt")
        write_dpt(p, d)
        paths.append(p)
        deps.append(d)
    got = native.batch_read_dpt(paths, n_threads=3)
    want = jax_native.batch_read_dpt(paths, n_threads=3)
    for g, w, d, p in zip(got, want, deps, paths):
        np.testing.assert_array_equal(g, d)
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(native.read_dpt(p),
                                      readers.read_depth(p))
        np.testing.assert_array_equal(native.read_dpt(p),
                                      jax_readers.read_depth(p))
    (tmp_path / "bad.dpt").write_bytes(b"nope")
    with pytest.raises(IOError):
        native.read_dpt(str(tmp_path / "bad.dpt"))
    # built into the git-ignored _build/, never beside the source
    assert native.library_path().parent.name == "_build"
    assert "native .dpt reader in use" in native.describe()


def _h5_datasets(path, rng):
    import h5py

    arrays = {
        "plain/u8": rng.integers(0, 255, (37, 45, 3), dtype=np.uint8),
        "plain/f32": rng.normal(size=(37, 45)).astype(np.float32),
        "gzip/u8": rng.integers(0, 255, (96, 128, 3), dtype=np.uint8),
        "gzip/f32": rng.normal(size=(96, 128)).astype(np.float32),
        "gzip/ragged": rng.normal(size=(50, 61)).astype(np.float32),
        "chunked/u16": rng.integers(0, 60000, (10, 11), dtype=np.uint16),
    }
    with h5py.File(path, "w") as f:
        for name, arr in arrays.items():
            kw = {}
            if name.startswith("gzip"):
                kw = dict(compression="gzip", compression_opts=9)
            if name in ("gzip/ragged", "chunked/u16"):
                kw["chunks"] = (7, 9)
            f.create_dataset(name, data=arr, **kw)
        f.create_dataset("refused/shuffle", data=np.zeros((4, 4), np.float32),
                         compression="gzip", shuffle=True)
        f.create_dataset("refused/lzf", data=np.zeros((4, 4), np.float32),
                         compression="lzf")
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_layout(h5py.h5d.COMPACT)
        h5py.h5d.create(f["refused"].id, b"compact", h5py.h5t.NATIVE_FLOAT,
                        h5py.h5s.create_simple((4, 4)), dcpl=dcpl)
    return arrays


def test_hdf5_dataset_without_h5py_matches_h5py(tmp_path, monkeypatch):
    """Contiguous and gzip-chunked (ragged edge chunks included) u8, u16 and
    f32 datasets read by the port's own reader equal h5py's read; other
    filters and the compact layout raise ValueError naming h5py."""
    path = tmp_path / "d.hdf5"
    arrays = _h5_datasets(path, np.random.default_rng(4))
    want = {name: readers.hdf5_dataset(path, name) for name in arrays}
    monkeypatch.setitem(sys.modules, "h5py", None)
    for name, arr in arrays.items():
        got = readers.hdf5_dataset(path, name)
        assert got.dtype == arr.dtype and got.shape == arr.shape
        np.testing.assert_array_equal(got, want[name])
        np.testing.assert_array_equal(got, arr)
    for name in ("refused/shuffle", "refused/lzf", "refused/compact"):
        with pytest.raises(ValueError, match="h5py"):
            readers.hdf5_dataset(path, name)
    with readers.open_hdf5(path) as f:
        assert isinstance(f, readers.Hdf5File)
        assert f.keys() == ["chunked", "gzip", "plain", "refused"]
        assert "gzip/u8" in f and "u8" in f["gzip"] and "nope" not in f
        assert np.array(f["gzip"]["u8"]).dtype == np.uint8
        with pytest.raises(KeyError):
            f["gzip/nope"]


def test_port_imports_neither_jax_nor_the_jax_package():
    """No module of ``rcvpose_tpu_torch`` imports jax or ``rcvpose_tpu``."""
    pkg = Path(__file__).resolve().parent.parent / "rcvpose_tpu_torch"
    pattern = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|orbax|"
                         r"tensorstore|zstandard|rcvpose_tpu)(\.|\s|$)",
                         re.M)
    sources = sorted(pkg.rglob("*.py"))
    assert len(sources) > 30
    for src in sources:
        assert not pattern.findall(src.read_text()), src
    for name in ("data/dataset.py", "data/loader.py", "data/genlabels.py",
                 "native/__init__.py", "checkdata.py", "profiling.py",
                 "cli.py"):
        assert (pkg / name).is_file(), name


def test_chip_smoke_ycb_training_file_reads_without_h5py(tmp_path,
                                                         monkeypatch):
    """The YCB training HDF5 of ``chip_smoke.py``'s phase 14 (its raw
    480x640 tree through ``generate_ycb`` with h5py hidden, as on the
    card: gzip-chunked images and radial maps from the port's own writer)
    trains through ``YcbDataset`` with the port's own reader as it does
    through h5py."""
    import chip_smoke
    from rcvpose_tpu_torch.data import genlabels

    name = "002_master_chef_can"
    chip_smoke.write_ycb_raw_tree(str(tmp_path))
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "h5py", None)
        ids = genlabels.generate_ycb(str(tmp_path), name, 1,
                                     progress=lambda *_: None, device="cpu")
    assert ids == [f"0000_{i:06d}" for i in range(1, 5)]
    ref = dataset.YcbDataset(str(tmp_path), name)
    want = [ref.raw(i) for i in range(4)]
    ref.close()
    monkeypatch.setitem(sys.modules, "h5py", None)
    port = dataset.YcbDataset(str(tmp_path), name)
    for i, w in enumerate(want):
        _same_sample(port.raw(i), w)
        assert w["image"].shape == (480, 640, 3)
        assert 0 < w["radial_dm"].max() < 10.0
    assert isinstance(port._h5, readers.Hdf5File)
    batch = next(loader.BatchLoader(port, K, 2, shuffle=False, ycb_clip=True,
                                    device="cpu").batches(0))
    assert batch["radial"].shape == (2, 480, 640)
    assert (batch["sem"] > 0).any()
