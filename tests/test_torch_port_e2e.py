"""The port's learned end-to-end proofs (``rcvpose_tpu_torch.scripts.e2e_*``)
and its HDF5 writer (``rcvpose_tpu_torch.data.hdf5_write``), on the CPU.

Against the JAX package's ``scripts/e2e_*.py`` (imported with
``importlib``; their module level imports numpy only): the synthetic world
(``make_object``, ``random_pose``, ``render_frame``, ``build_dataset``,
``aimed_poses``) bit for bit, the radius clips and the vote grid, the
labels and the epoch batch order (the JAX script's own ``train_batches``,
captured by running its ``main`` up to serving with the JAX ``Trainer``,
``Checkpointer`` and ``PoseEstimator`` replaced by recorders), the image
normalization, and the LMO and YCB trees the writers put on disk. The
HDF5 writer against h5py and the port's own reader. The synthetic proof
(3-net, and ``--fused --fast-head``) at ``--small --device cpu``,
in-process, under the JAX script's small criterion, with the JAX record's
keys (``run_main``; the evaluator proofs' smokes are in
``test_torch_port_e2e_eval.py``). Every entry point raises without a card
unless the CPU is named, and the new modules import with JAX,
``rcvpose_tpu``, the repo's ``scripts/`` and h5py blocked.
"""

import ast
import importlib.util
import inspect
import json
import pathlib
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from rcvpose_tpu_torch import eval as port_eval
from rcvpose_tpu_torch import geometry
from rcvpose_tpu_torch import labels as port_labels
from rcvpose_tpu_torch.data import hdf5_write, readers
from rcvpose_tpu_torch.ops import voting as port_voting
from rcvpose_tpu_torch.scripts import (e2e_fused_train, e2e_lmo,
                                       e2e_overflow_retry, e2e_synthetic,
                                       e2e_ycb)

REPO = pathlib.Path(__file__).resolve().parent.parent
JAX_SCRIPTS = REPO / "scripts"
# label tolerance (dm), as tests/test_torch_port_train.py holds labels
RADIAL_ATOL = 1e-5
NORMALIZE_ATOL = 1e-6


@pytest.fixture
def one_thread():
    """One intra-op thread for a test held against the port alone (the
    suite's other workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_script(name):
    """The JAX package's ``scripts/<name>.py`` as a module; the script's
    own ``sys.path`` inserts are undone after the import."""
    saved = list(sys.path)
    try:
        spec = importlib.util.spec_from_file_location(
            f"jax_{name}", JAX_SCRIPTS / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = saved
    return mod


def _key(node):
    if isinstance(node, ast.JoinedStr):
        return "".join(v.value if isinstance(v, ast.Constant) else "{}"
                       for v in node.values)
    return node.value


def record_keys(path):
    """The keys of the record a script prints: every dict literal with a
    ``"metric"`` key, plus the ``name["..."] = ...`` assignments of the
    name it is bound to."""
    tree = ast.parse(pathlib.Path(path).read_text())
    keys, bound = set(), set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            ks = [_key(k) for k in node.keys if k is not None]
            if "metric" in ks:
                keys.update(ks)
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict):
            ks = [_key(k) for k in node.value.keys if k is not None]
            if "metric" in ks:
                bound.update(t.id for t in node.targets
                             if isinstance(t, ast.Name))
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if (isinstance(t, ast.Subscript)
                        and isinstance(t.value, ast.Name)
                        and t.value.id in bound):
                    keys.add(_key(t.slice))
    return keys


# ---------------------------------------------------------------------------
# The synthetic world, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hw", [(64, 64), (256, 320)])
@pytest.mark.parametrize("seed", [0, 1])
def test_world_is_the_jax_scripts(seed, hw):
    jx = jax_script("e2e_synthetic_tpu")
    jlmo = jax_script("e2e_lmo_tpu")
    h, w = hw
    for name in ("HALF_EXTENTS", "KEYPOINTS_M"):
        np.testing.assert_array_equal(getattr(e2e_synthetic, name),
                                      getattr(jx, name))
    assert e2e_synthetic.DIAMETER_M == jx.DIAMETER_M
    assert e2e_synthetic.ADD_THRESHOLD_MM == jx.ADD_THRESHOLD_MM
    k = e2e_synthetic.scaled_linemod_k(h, w)
    scale = w / 640.0   # the JAX scripts' inline K
    np.testing.assert_array_equal(k, np.array(
        [[572.4114 * scale, 0.0, w / 2.0], [0.0, 573.5704 * scale, h / 2.0],
         [0.0, 0.0, 1.0]], np.float32))

    def both(fn, *args, **kw):
        a = getattr(e2e_synthetic, fn)(np.random.default_rng(seed), *args,
                                       **kw)
        b = getattr(jx, fn)(np.random.default_rng(seed), *args, **kw)
        return a, b

    (pts, colors, cad), want = both("make_object")
    for got, exp in zip((pts, colors, cad), want):
        assert got.dtype == exp.dtype
        np.testing.assert_array_equal(got, exp)
    pose, want = both("random_pose", z_range=(0.5, 1.0))
    np.testing.assert_array_equal(pose, want)
    for p in (e2e_synthetic.random_pose(np.random.default_rng(seed + 7)),
              pose):
        got = e2e_synthetic.render_frame(p, pts, colors, k, h, w)
        exp = jx.render_frame(p, pts, colors, k, h, w)
        for a, b in zip(got, exp):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert (got[1] > 0).any()
    got, want = both("build_dataset", 3, pts, colors, k, h, w)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    lk = np.asarray(geometry.LINEMOD_K, np.float32)
    for window in (((80, 240), (80, 176), (0.78, 1.0)),
                   ((48, 112), (48, 80), (1.2, 1.5))):
        got = e2e_lmo.aimed_poses(np.random.default_rng(seed), 4, lk,
                                  *window)
        want = jlmo.aimed_poses(np.random.default_rng(seed), 4, lk, *window)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_radius_clips_and_grid_are_the_jax_packages():
    from rcvpose_tpu.ops.voting import suggest_grid_l

    jfused = jax_script("e2e_fused_train")
    jx = jax_script("e2e_synthetic_tpu")
    for seed in (0, 1):
        _, _, cad = e2e_synthetic.make_object(np.random.default_rng(seed))
        got = e2e_fused_train.per_kpt_max_radii_dm(cad,
                                                   e2e_synthetic.KEYPOINTS_M)
        want = jfused.per_kpt_max_radii_dm(cad, jx.KEYPOINTS_M)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        for diam, r in ((e2e_synthetic.DIAMETER_M, float(got.max())),
                        (0.1, 0.5), (0.3, 3.0), (0.05, 0.1)):
            assert port_voting.suggest_grid_l(diam, r) == suggest_grid_l(
                diam, r)


def test_normalize_image_is_the_jax_packages():
    import jax

    from rcvpose_tpu import labels as jax_labels

    img = np.random.default_rng(0).integers(0, 256, size=(3, 16, 20, 3),
                                            dtype=np.uint8)
    want = np.asarray(jax.vmap(jax_labels.normalize_image)(img))
    got = port_labels.normalize_image(torch.as_tensor(img)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=NORMALIZE_ATOL)
    got = e2e_synthetic.normalized_images(img, "cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=NORMALIZE_ATOL)


class _Stop(Exception):
    pass


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX script's ``main --small`` up to serving: its Trainer,
    Checkpointer and PoseEstimator replaced by recorders (its labels,
    normalized images and batch factories are the script's own), its
    compile-cache setup by nothing. Returns {"trainers": [Trainer kwargs
    per keypoint], "estimator": (args, kwargs)}."""
    import rcvpose_tpu.checkpoint as jckpt
    import rcvpose_tpu.infer as jinfer
    import rcvpose_tpu.train as jtrain
    import rcvpose_tpu.utils as jutils

    seen = {"trainers": []}

    class Trainer:
        def __init__(self, **kw):
            seen["trainers"].append(kw)
            self.state, self.iteration = None, 0

        def fit(self, max_epochs):
            time.sleep(1e-3)

        def validate(self, epoch):
            return 0.0

    class Checkpointer:
        def __init__(self, directory):
            pass

        def save(self, *a, **kw):
            pass

        def wait_until_finished(self):
            pass

        def restore(self, state):
            return types.SimpleNamespace(params=None, batch_stats=None), 0, \
                0, 0.0

    def estimator(*args, **kw):
        seen["estimator"] = (args, kw)
        raise _Stop

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jtrain, "create_state", lambda *a, **kw: None)
        mp.setattr(jtrain, "make_parallel_steps", lambda *a, **kw: None)
        mp.setattr(jtrain, "Trainer", Trainer)
        mp.setattr(jckpt, "Checkpointer", Checkpointer)
        mp.setattr(jinfer, "PoseEstimator", estimator)
        mp.setattr(jutils, "setup_script_cache", lambda **kw: None)
        out = tmp_path_factory.mktemp("jax_e2e")
        mp.setattr(sys, "argv", ["e2e_synthetic_tpu.py", "--small",
                                 "--out", str(out)])
        with pytest.raises(_Stop):
            jax_script("e2e_synthetic_tpu").main()
    finally:
        mp.undo()
    return seen


def _port_world(small=True):
    """The port script's frames at ``--small``: (k, poses, images, depths,
    cad_m, max_radii_dm, n_train)."""
    h = w = 64
    k = e2e_synthetic.scaled_linemod_k(h, w)
    rng = np.random.default_rng(0)
    pts, colors, cad = e2e_synthetic.make_object(rng)
    poses, images, depths = e2e_synthetic.build_dataset(rng, 10, pts,
                                                        colors, k, h, w)
    return (k, poses, images, depths, cad,
            e2e_synthetic.per_kpt_max_radii_dm(cad,
                                               e2e_synthetic.KEYPOINTS_M), 8)


def test_labels_are_the_jax_scripts(jax_run):
    k, poses, _, depths, _, max_radii, _ = _port_world()
    assert len(jax_run["trainers"]) == 3
    for kp_i, kw in enumerate(jax_run["trainers"]):
        _, jradial, jsem = kw["train_batches"].__defaults__
        radial, sem = e2e_synthetic.frame_labels(
            depths, poses, k, e2e_synthetic.KEYPOINTS_M[kp_i + 1],
            max_radii[kp_i], "cpu")
        assert radial.shape == jradial.shape == (10, 64, 64)
        np.testing.assert_array_equal(sem.numpy(), np.asarray(jsem))
        np.testing.assert_allclose(radial.numpy(), np.asarray(jradial),
                                   rtol=0, atol=RADIAL_ATOL)
        assert (np.asarray(jsem) > 0).sum() > 50
    # the fused labels stack the keypoints on a last axis
    radial, sem = e2e_synthetic.frame_labels(
        depths, poses, k, e2e_synthetic.KEYPOINTS_M[1:4], max_radii, "cpu")
    for kp_i, kw in enumerate(jax_run["trainers"]):
        _, jradial, jsem = kw["train_batches"].__defaults__
        np.testing.assert_array_equal(sem[..., kp_i].numpy(),
                                      np.asarray(jsem))
        np.testing.assert_allclose(radial[..., kp_i].numpy(),
                                   np.asarray(jradial), rtol=0,
                                   atol=RADIAL_ATOL)


def test_epoch_batch_order_is_the_jax_scripts(jax_run):
    k, poses, images, depths, _, max_radii, n_train = _port_world()
    images_norm = e2e_synthetic.normalized_images(images, "cpu")
    for kp_i, kw in enumerate(jax_run["trainers"]):
        factory = kw["train_batches"]
        _, jradial, _ = factory.__defaults__
        jradial = np.asarray(jradial)
        jimages = np.asarray(
            inspect.getclosurevars(factory).nonlocals["images_norm"])
        np.testing.assert_allclose(images_norm.numpy(), jimages, rtol=0,
                                   atol=NORMALIZE_ATOL)
        radial, sem = e2e_synthetic.frame_labels(
            depths, poses, k, e2e_synthetic.KEYPOINTS_M[kp_i + 1],
            max_radii[kp_i], "cpu")
        train_b, val_b = e2e_synthetic.batch_factories(
            images_norm, radial, sem, n_train, 2, kp_i, np.arange(8, 10))
        for epoch in range(4):
            order = e2e_synthetic.epoch_batches(epoch, kp_i, n_train, 2)
            want = list(factory(epoch))
            got = list(train_b(epoch))
            assert len(got) == len(want) == len(order) == 4
            for idx, b, p in zip(order, want, got):
                # the JAX batch is its own maps at the port's indices, and
                # the port's batch is its own maps at the same indices
                np.testing.assert_array_equal(np.asarray(b["radial"]),
                                              jradial[idx])
                np.testing.assert_array_equal(np.asarray(b["image"]),
                                              jimages[idx])
                for key, full in (("image", images_norm), ("radial", radial),
                                  ("sem", sem)):
                    np.testing.assert_array_equal(p[key].numpy(),
                                                  full.numpy()[idx])
        (val,), (pval,) = list(kw["val_batches"]()), list(val_b())
        np.testing.assert_array_equal(np.asarray(val["radial"]),
                                      jradial[8:10])
        np.testing.assert_array_equal(pval["radial"].numpy(),
                                      radial.numpy()[8:10])
    # the tail is dropped, as the JAX scripts drop it
    assert [len(b) for b in e2e_synthetic.epoch_batches(0, 0, 7, 2)] == [2] * 3


def test_serving_inputs_are_the_jax_scripts(jax_run):
    k, _, _, _, cad, max_radii, _ = _port_world()
    args, kw = jax_run["estimator"]
    cfg = args[0]
    np.testing.assert_array_equal(kw["k"], k)
    np.testing.assert_array_equal(kw["max_radii_dm"], max_radii)
    np.testing.assert_array_equal(kw["cad_mm"], cad * 1000.0)
    assert cfg.vote_grid_l == min(port_voting.suggest_grid_l(
        e2e_synthetic.DIAMETER_M, float(max_radii.max())), 96)
    assert (cfg.max_points, cfg.sem_threshold) == (1024, 0.8)


# ---------------------------------------------------------------------------
# The LMO and YCB trees on disk
# ---------------------------------------------------------------------------

def _tree_files(root):
    return sorted(str(p.relative_to(root)) for p in pathlib.Path(root).rglob(
        "*") if p.is_file())


def _lmo_frames():
    lk = np.asarray(geometry.LINEMOD_K, np.float32)
    rng = np.random.default_rng(1)
    pts, colors, cad = e2e_synthetic.make_object(rng)
    poses = e2e_lmo.aimed_poses(rng, 4, lk, (48, 112), (48, 80), (1.2, 1.5))
    frames = [e2e_synthetic.render_frame(p, pts, colors, lk, 128, 160)
              for p in poses]
    return (cad, poses, np.stack([f[0] for f in frames]),
            np.stack([f[1] for f in frames]))


def test_lmo_tree_is_the_jax_scripts(tmp_path):
    jlmo = jax_script("e2e_lmo_tpu")
    cad, poses, images, depths = _lmo_frames()
    saved = list(sys.path)
    try:
        sys.path.insert(0, str(REPO))   # the JAX writer's tests.test_data
        jlmo.write_lmo_tree(str(tmp_path / "jax"), "ape", cad, poses[:3],
                            images, depths)
    finally:
        sys.path[:] = saved
    e2e_lmo.write_lmo_tree(str(tmp_path / "port"), "ape", cad, poses[:3],
                           images, depths)
    files = _tree_files(tmp_path / "port")
    assert files == _tree_files(tmp_path / "jax")
    assert "OCCLUSION_LINEMOD/RGB-D/rgb_noseg/color_00003.png" in files
    assert "OCCLUSION_LINEMOD/blender_poses/ape/pose3.npy" not in files
    for f in files:
        assert (tmp_path / "port" / f).read_bytes() == (
            tmp_path / "jax" / f).read_bytes(), f


def _ycb_frames(n=3):
    h = w = 64
    k = e2e_synthetic.scaled_linemod_k(h, w)
    rng = np.random.default_rng(0)
    pts, colors, cad = e2e_synthetic.make_object(rng)
    poses, images, depths = e2e_synthetic.build_dataset(rng, n, pts, colors,
                                                        k, h, w)
    return cad, poses, images, depths, k


def test_ycb_tree_is_the_jax_scripts(tmp_path):
    import h5py
    import scipy.io

    jycb = jax_script("e2e_ycb_tpu")
    cad, poses, images, depths, k = _ycb_frames()
    for mod, name in ((jycb, "jax"), (e2e_ycb, "port")):
        mod.write_ycb_tree(str(tmp_path / name), "003_cracker_box", 3, cad,
                           poses, images, depths, k)
    files = _tree_files(tmp_path / "port")
    assert files == _tree_files(tmp_path / "jax")
    assert "003_cracker_box.hdf5" in files and "data/0000/000003.mat" in files
    for f in files:
        a, b = tmp_path / "port" / f, tmp_path / "jax" / f
        if f.endswith(".mat"):
            ma, mb = scipy.io.loadmat(a), scipy.io.loadmat(b)
            keys = {x for x in ma if not x.startswith("__")}
            assert keys == {x for x in mb if not x.startswith("__")}
            for x in keys:
                assert ma[x].dtype == mb[x].dtype
                np.testing.assert_array_equal(ma[x], mb[x])
        elif f.endswith(".hdf5"):
            with h5py.File(a, "r") as fa, h5py.File(b, "r") as fb:
                assert list(fa.keys()) == list(fb.keys()) == ["JPEGImages"]
                ka = list(fa["JPEGImages"].keys())
                assert ka == list(fb["JPEGImages"].keys()) == [
                    "0000_000001", "0000_000002", "0000_000003"]
                for x in ka:
                    da, db = np.array(fa["JPEGImages"][x]), np.array(
                        fb["JPEGImages"][x])
                    assert da.dtype == db.dtype and da.shape == db.shape
                    np.testing.assert_array_equal(da, db)
        else:
            assert a.read_bytes() == b.read_bytes(), f


@pytest.mark.parametrize("h5py_present", [True, False])
def test_ycb_frame_listing_reads_the_written_hdf5(tmp_path, monkeypatch,
                                                  h5py_present):
    import scipy.io

    cad, poses, images, depths, k = _ycb_frames(n=4)
    e2e_ycb.write_ycb_tree(str(tmp_path), "003_cracker_box", 3, cad, poses,
                           images, depths, k)
    if not h5py_present:
        monkeypatch.setitem(sys.modules, "h5py", None)
    metas = port_eval._ycb_class_frames(str(tmp_path), "003_cracker_box", 3,
                                        None, scipy.io)
    assert [m[0] for m in metas] == [f"0000_{i:06d}" for i in range(1, 5)]
    for (_, rt, kk, factor), pose in zip(metas, poses):
        np.testing.assert_array_equal(rt, pose)
        np.testing.assert_array_equal(kk, k)
        assert factor == 10000.0


# ---------------------------------------------------------------------------
# The HDF5 writer
# ---------------------------------------------------------------------------

def _datasets(n, seed=0):
    rng = np.random.default_rng(seed)
    out = {f"JPEGImages/{c:04d}_{i:06d}": rng.integers(
        0, 256, size=(4, 5, 3), dtype=np.uint8)
        for c, i in zip(rng.permutation(n), rng.permutation(n) + 1)}
    out["radius/f32"] = rng.normal(size=(3, 7)).astype(np.float32)
    out["radius/deep/f64"] = rng.normal(size=(2, 2, 2))
    out["u16"] = np.arange(12, dtype=np.uint16).reshape(3, 4)
    out["i32"] = np.array([-5, 0, 7], np.int32)
    out["i64_scalar"] = np.array(-3, np.int64)
    return out


def _check_read(f, datasets):
    groups = {}
    for name in datasets:
        head, _, tail = name.rpartition("/")
        groups.setdefault(head, []).append(tail)
    for head, members in groups.items():
        node = f[head] if head else f
        names = [m for m in node.keys()]
        direct = [n for n in names if n in members]
        assert direct == sorted(members, key=str.encode)
    for name, arr in datasets.items():
        got = np.array(f[name])
        assert got.dtype == arr.dtype and got.shape == arr.shape, name
        np.testing.assert_array_equal(got, arr)


@pytest.mark.parametrize("n", [1, 8, 100, 300])
def test_hdf5_writer_reads_back_in_h5py_and_the_port(tmp_path, n):
    """1 name, a full symbol-table node (2 x leaf K = 8), 13 nodes under
    one B-tree node and 38 nodes under a second B-tree level."""
    import h5py

    data = _datasets(n)
    path = hdf5_write.write_hdf5(str(tmp_path / "f.hdf5"), data)
    with h5py.File(path, "r") as f:
        assert list(f.keys()) == ["JPEGImages", "i32", "i64_scalar",
                                  "radius", "u16"]
        _check_read(f, data)
    with readers.Hdf5File(path) as f:
        _check_read(f, data)
    assert readers.hdf5_group_keys(path, "JPEGImages") == sorted(
        k.split("/")[1] for k in data if k.startswith("JPEGImages/"))


def test_hdf5_writer_refusals_and_float16(tmp_path):
    path = str(tmp_path / "g.hdf5")
    hdf5_write.write_hdf5(path, {"a/b": np.zeros((2, 2), np.float16)})
    with readers.Hdf5File(path) as f:
        assert np.array(f["a/b"]).dtype == np.float16
    with pytest.raises(TypeError, match="no HDF5 datatype"):
        hdf5_write.write_hdf5(path, {"x": np.zeros(2, bool)})
    with pytest.raises(ValueError, match="passes through a dataset"):
        hdf5_write.write_hdf5(path, {"x": np.zeros(2), "x/y": np.zeros(2)})
    with pytest.raises(ValueError, match="bad dataset name"):
        hdf5_write.write_hdf5(path, {"/": np.zeros(2)})


_NAME = st.text(alphabet="abcXYZ019_-.+ ", min_size=1, max_size=12).filter(
    lambda s: s != ".")


@settings(max_examples=25, deadline=None)
@given(st.dictionaries(
    st.lists(_NAME, min_size=1, max_size=3).map("/".join),
    st.tuples(st.sampled_from([np.uint8, np.float32]),
              st.lists(st.integers(1, 4), min_size=0, max_size=3),
              st.integers(0, 2 ** 32 - 1)),
    min_size=1, max_size=20))
def test_hdf5_writer_round_trips_any_names(tmp_path_factory, spec):
    import h5py

    names = sorted(spec)
    # no name may be a group on another name's path
    prefixes = {"/".join(n.split("/")[:i]) for n in names
                for i in range(1, n.count("/") + 1)}
    data = {}
    for name in names:
        if name in prefixes:
            continue
        dtype, shape, seed = spec[name]
        rng = np.random.default_rng(seed)
        arr = rng.integers(0, 256, size=shape) if dtype is np.uint8 else \
            rng.normal(size=shape)
        data[name] = np.asarray(arr, dtype)
    path = hdf5_write.write_hdf5(
        str(tmp_path_factory.mktemp("h") / "f.hdf5"), data)
    with h5py.File(path, "r") as f:
        _check_read(f, data)
    with readers.Hdf5File(path) as f:
        _check_read(f, data)


# ---------------------------------------------------------------------------
# The entry points on the CPU
# ---------------------------------------------------------------------------

# keys each port record adds to the JAX record's
ADDED = {"e2e_synthetic": {"device", "conv_route"}, "e2e_lmo": {"device"},
         "e2e_ycb": {"device"},
         "e2e_overflow_retry": {"device", "overflow_frames"}}
JAX_NAMES = {"e2e_synthetic": "e2e_synthetic_tpu", "e2e_lmo": "e2e_lmo_tpu",
             "e2e_ycb": "e2e_ycb_tpu",
             "e2e_overflow_retry": "e2e_overflow_retry_tpu"}


def run_main(mod, argv, capsys):
    """``mod.main(argv)``: (exit code, its last stdout line as JSON)."""
    rc = mod.main(argv)
    lines = capsys.readouterr().out.strip().splitlines()
    record = json.loads(lines[-1])
    name = mod.__name__.rsplit(".", 1)[1]
    want = record_keys(JAX_SCRIPTS / f"{JAX_NAMES[name]}.py") | ADDED[name]
    optional = {"icp_criteria_compare"}    # only with --icp_compare
    assert set(record) - optional == want - optional
    assert ("icp_criteria_compare" in record) == ("--icp_compare" in argv)
    assert record["backend"] == "cpu" and record["device"] == "cpu"
    return rc, record


@pytest.mark.usefixtures("one_thread")
def test_synthetic_proof_runs_on_the_cpu(tmp_path, capsys):
    rc, rec = run_main(e2e_synthetic, ["--small", "--device", "cpu", "--out",
                                       str(tmp_path)], capsys)
    assert rc == 0
    assert rec["metric"] == "e2e_synthetic_add_pass_rate"
    assert rec["frames"] == {"train": 8, "test": 2}
    assert rec["kpt_heads"] == 1 and rec["conv_route"] == "cuDNN"
    assert np.isfinite(rec["mean_add_after_icp_mm"])
    for tag in ("kpt1", "kpt2", "kpt3"):
        assert (tmp_path / tag / "ckpt.pth.tar").is_file()


@pytest.mark.usefixtures("one_thread")
def test_fused_fast_head_proof_runs_on_the_cpu(tmp_path, capsys):
    rc, rec = run_main(e2e_synthetic, [
        "--small", "--fused", "--fast-head", "--steps", "1", "--device",
        "cpu", "--out", str(tmp_path)], capsys)
    assert rc == 0
    assert rec["kpt_heads"] == 3 and "fused" in rec["model"]
    assert rec["train_steps_per_kpt"] == 1
    assert (tmp_path / "fused" / "ckpt.pth.tar").is_file()


@pytest.mark.parametrize("mod", [e2e_synthetic, e2e_lmo, e2e_ycb,
                                 e2e_overflow_retry])
def test_entry_points_raise_without_a_card(mod, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(["--small"])


def test_new_modules_import_without_jax_or_the_jax_package(tmp_path):
    code = "\n".join([
        "import sys",
        "for m in ('jax', 'jaxlib', 'rcvpose_tpu', 'scripts', 'h5py',",
        "          'e2e_synthetic_tpu', 'e2e_fused_train', 'tests'):",
        "    sys.modules[m] = None",
        "import numpy as np",
        "from rcvpose_tpu_torch.data import hdf5_write, readers",
        "from rcvpose_tpu_torch.scripts import (e2e_synthetic,",
        "    e2e_fused_train, e2e_lmo, e2e_ycb, e2e_overflow_retry)",
        f"p = hdf5_write.write_hdf5({str(tmp_path / 'f.hdf5')!r},",
        "    {'JPEGImages/b': np.ones(3, np.uint8),",
        "     'JPEGImages/a': np.zeros(2, np.float32)})",
        "assert readers.hdf5_group_keys(p, 'JPEGImages') == ['a', 'b']",
        "assert not any(m.startswith(('jax', 'rcvpose_tpu.'))",
        "               for m in sys.modules if sys.modules[m] is not None)",
        "print('ok')",
    ])
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "ok"
