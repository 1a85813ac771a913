"""The port's ``gen-labels`` writers and ``check-data`` walker against the
JAX package's, on the CPU.

``generate_lm`` (and ``fake_depth``) maps within 1e-5 (dm, or m for the
fake depth) of the JAX files, ``generate_ycb``'s HDF5 the same datasets
with images equal and radii within 1e-5 dm, split files equal; the
findings of ``check_lm`` / ``check_lmo`` / ``check_ycb`` / ``run_check``
identical, message for message, on clean trees and on each broken tree of
``tests/test_checkdata.py``.
"""

import os
import sys

import numpy as np
import pytest

from rcvpose_tpu import checkdata as jax_checkdata
from rcvpose_tpu.config import Config as JaxConfig
from rcvpose_tpu.data import genlabels as jax_genlabels
from rcvpose_tpu_torch import checkdata
from rcvpose_tpu_torch.config import Config
from rcvpose_tpu_torch.data import genlabels, readers
from tests.test_data import make_linemod_tree, write_ascii_ply
from tests.test_eval_lm_format import make_lm_eval_tree
from tests.test_eval_lmo_ycb_format import make_ycb_eval_tree
from tests.test_genlabels import YCB_CLASS, YCB_ID, _ycb_raw_tree

ATOL = 1e-5


def _poses_facing_the_frame(root, n):
    """Rewrite the tree's poses so that keypoint 1 sits in front of the
    48x64 frame's centre pixel at about 0.7 m (LINEMOD intrinsics): the
    fixture's own random poses put every keypoint beyond its max radius,
    which would make every map zero."""
    from rcvpose_tpu_torch import geometry

    base = os.path.join(root, "toy")
    k = geometry.LINEMOD_K
    kpt = np.load(os.path.join(base, "Outside9.npy"))[1]
    for i in range(n):
        z = 0.7 + 0.02 * i
        centre = np.array([(32 - k[0, 2]) * z / k[0, 0],
                           (24 - k[1, 2]) * z / k[1, 1], z])
        pose = np.concatenate([np.eye(3), (centre - kpt)[:, None]], axis=1)
        np.save(os.path.join(base, "pose", f"pose{i}.npy"), pose)


@pytest.mark.parametrize("fake_depth", [False, True])
def test_generate_lm_matches_jax(tmp_path, fake_depth):
    root = make_linemod_tree(tmp_path, np.random.default_rng(0), n_frames=5)
    _poses_facing_the_frame(root, 5)
    kpts = [1] if fake_depth else [1, 2]
    for name, gen, kw in (("jax", jax_genlabels.generate_lm, {}),
                          ("port", genlabels.generate_lm,
                           {"device": "cpu"})):
        gen(root, "toy", kpt_indices=kpts, batch_size=2,
            out_root=str(tmp_path / name), progress=lambda *_: None,
            fake_depth=fake_depth, **kw)
    dirs = ["FakeDepth"] if fake_depth else ["Out_pt1_dm", "Out_pt2_dm"]
    for d in dirs:
        names = sorted(os.listdir(tmp_path / "jax" / d))
        assert names == sorted(os.listdir(tmp_path / "port" / d))
        assert len(names) == 5
        for fn in names:
            want = np.load(tmp_path / "jax" / d / fn)
            got = np.load(tmp_path / "port" / d / fn)
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
            if d != "Out_pt2_dm":
                assert (want > 0).any()


def _ycb_contents(path):
    """{name: array} of every dataset of an HDF5 file, read by h5py."""
    import h5py

    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda name, obj: out.__setitem__(
            name, np.array(obj)) if isinstance(obj, h5py.Dataset) else None)
    return out


def _same_ycb_files(got_path, want_path, n_datasets):
    got, want = _ycb_contents(got_path), _ycb_contents(want_path)
    assert sorted(got) == sorted(want) and len(want) == n_datasets
    for key, arr in want.items():
        assert got[key].dtype == arr.dtype and got[key].shape == arr.shape
        if key.startswith("3Dradius"):
            np.testing.assert_allclose(got[key], arr, rtol=0, atol=ATOL)
        else:
            np.testing.assert_array_equal(got[key], arr)
    return got


def _ycb_roots(tmp_path, n_frames=2):
    roots = {}
    for name in ("jax", "port"):
        roots[name] = str(tmp_path / name)
        os.makedirs(roots[name])
        _ycb_raw_tree(roots[name], np.random.default_rng(5),
                      n_frames=n_frames)
    return roots


def _generate_both(roots):
    want = jax_genlabels.generate_ycb(roots["jax"], YCB_CLASS, YCB_ID,
                                      progress=lambda *_: None)
    got = genlabels.generate_ycb(roots["port"], YCB_CLASS, YCB_ID,
                                 progress=lambda *_: None, device="cpu")
    assert got == want
    return got


def _stored_chunks(path, name):
    """The stored bytes, filter masks and offsets of a dataset's chunks,
    as the file holds them."""
    with readers.Hdf5File(path) as f:
        reader = f._reader
        entry = f[name]._entry
        kind, _, records = reader.stored(entry)
        assert kind == "chunked"
        return sorted((bytes(reader.data[at:at + size]), mask, offset)
                      for at, size, mask, offset in records)


def test_generate_ycb_matches_jax(tmp_path):
    roots = _ycb_roots(tmp_path)
    assert len(_generate_both(roots)) == 2
    _same_ycb_files(os.path.join(roots["port"], f"{YCB_CLASS}.hdf5"),
                    os.path.join(roots["jax"], f"{YCB_CLASS}.hdf5"), 8)
    for rel in (os.path.join(YCB_CLASS, "Split", "val.txt"),
                os.path.join("Split", YCB_CLASS, "val.txt")):
        with open(os.path.join(roots["port"], rel)) as f, \
                open(os.path.join(roots["jax"], rel)) as g:
            assert f.read() == g.read()


def test_generate_ycb_twice_keeps_images_and_replaces_maps_as_jax(tmp_path):
    """h5py's "a" mode: between the runs the colour and depth PNGs of a
    frame change; the second run keeps the first run's image (its stored
    chunk too) and writes the new depth's maps, in both packages."""
    from PIL import Image

    roots = _ycb_roots(tmp_path)
    ids = _generate_both(roots)
    port_h5 = os.path.join(roots["port"], f"{YCB_CLASS}.hdf5")
    jax_h5 = os.path.join(roots["jax"], f"{YCB_CLASS}.hdf5")
    first = _ycb_contents(port_h5)
    image_chunks = _stored_chunks(port_h5, f"JPEGImages/{ids[0]}")
    for root in roots.values():
        cdir = os.path.join(root, "data", "0000")
        color = os.path.join(cdir, "000001-color.png")
        Image.fromarray(255 - np.asarray(Image.open(color))).save(color)
        dpath = os.path.join(cdir, "000001-depth.png")
        depth = np.asarray(Image.open(dpath)).astype(np.int32)
        Image.fromarray(np.where(depth > 0, depth + 500, 0)).save(dpath)
    assert _generate_both(roots) == ids
    second = _same_ycb_files(port_h5, jax_h5, 8)
    for key, arr in first.items():
        if key.startswith("JPEGImages") or ids[1] in key:
            np.testing.assert_array_equal(second[key], arr)
        else:
            assert not np.array_equal(second[key], arr), key
    assert _stored_chunks(port_h5, f"JPEGImages/{ids[0]}") == image_chunks


def test_generate_ycb_carries_what_h5py_wrote_as_stored(tmp_path):
    """An extra keypoint's group, an attribute and an empty group that
    h5py wrote stay in the port's file, their chunks byte for byte."""
    import h5py

    roots = _ycb_roots(tmp_path, n_frames=1)
    extra = np.random.default_rng(1).uniform(size=(64, 64)).astype(
        np.float32)
    for root in roots.values():
        with h5py.File(os.path.join(root, f"{YCB_CLASS}.hdf5"), "w") as f:
            f.create_dataset("3Dradius_pt4_dm/0000_000001", data=extra,
                             compression="gzip", compression_opts=9,
                             chunks=(16, 32))
            f["3Dradius_pt4_dm"].attrs["unit"] = np.float32(0.1)
            f.create_group("notes")
    port_h5 = os.path.join(roots["port"], f"{YCB_CLASS}.hdf5")
    before = _stored_chunks(port_h5, "3Dradius_pt4_dm/0000_000001")
    assert len(before) == 8
    _generate_both(roots)
    got = _same_ycb_files(port_h5, os.path.join(roots["jax"],
                                                f"{YCB_CLASS}.hdf5"), 5)
    np.testing.assert_array_equal(got["3Dradius_pt4_dm/0000_000001"], extra)
    assert _stored_chunks(port_h5, "3Dradius_pt4_dm/0000_000001") == before
    with h5py.File(port_h5, "r") as f:
        assert f["3Dradius_pt4_dm"].attrs["unit"] == np.float32(0.1)
        assert list(f["notes"].keys()) == []


def test_generate_ycb_without_h5py_matches_jax(tmp_path, monkeypatch):
    roots = _ycb_roots(tmp_path)
    jax_genlabels.generate_ycb(roots["jax"], YCB_CLASS, YCB_ID,
                               progress=lambda *_: None)
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "h5py", None)
        genlabels.generate_ycb(roots["port"], YCB_CLASS, YCB_ID,
                               progress=lambda *_: None, device="cpu")
        with readers.Hdf5File(os.path.join(roots["port"],
                                           f"{YCB_CLASS}.hdf5")) as f:
            assert sorted(f["JPEGImages"].keys()) == ["0000_000001",
                                                      "0000_000002"]
    _same_ycb_files(os.path.join(roots["port"], f"{YCB_CLASS}.hdf5"),
                    os.path.join(roots["jax"], f"{YCB_CLASS}.hdf5"), 8)


def test_generate_ycb_without_scipy_names_it(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "scipy.io", None)
    with pytest.raises(ImportError, match="scipy.io"):
        genlabels.generate_ycb(str(tmp_path), YCB_CLASS, YCB_ID,
                               device="cpu")


# ---------------------------------------------------------------------------
# check-data: the broken trees of tests/test_checkdata.py
# ---------------------------------------------------------------------------

def _lm_mm_ply(root):
    ply = os.path.join(root, "LINEMOD", "ape", "ape.ply")
    write_ascii_ply(ply, readers.read_ply_points(ply) * 1000.0)


def _lm_missing_frame_bad_pose(root):
    os.remove(os.path.join(root, "LINEMOD", "ape", "JPEGImages",
                           "000000.jpg"))
    pose_p = os.path.join(root, "LINEMOD", "ape", "pose", "pose1.npy")
    pose = np.load(pose_p)
    pose[:, 3] *= 1000.0
    np.save(pose_p, pose)


def _lm_mm_keypoints(root):
    kp = os.path.join(root, "LINEMOD", "ape", "Outside9.npy")
    np.save(kp, np.load(kp) * 1000.0)


def _lm_keypoint_shape(root):
    np.save(os.path.join(root, "LINEMOD", "ape", "Outside9.npy"),
            np.zeros((4, 3)))


def _lm_no_split(root):
    os.remove(os.path.join(root, "LINEMOD", "ape", "Split", "val.txt"))


def _lm_corrupt_files(root):
    pv = os.path.join(root, "LINEMOD", "ape")
    with open(os.path.join(pv, "Outside9.npy"), "wb") as f:
        f.write(b"\x93NUMPY garbage")
    frame_id = open(os.path.join(pv, "Split", "val.txt")).read().split()[0]
    with open(os.path.join(pv, "pose", f"pose{int(frame_id)}.npy"),
              "wb") as f:
        f.write(b"not a npy")


LM_CASES = {"clean": None, "mm ply": _lm_mm_ply,
            "missing frame, bad pose": _lm_missing_frame_bad_pose,
            "mm keypoints": _lm_mm_keypoints,
            "keypoint shape": _lm_keypoint_shape, "no split": _lm_no_split,
            "corrupt files": _lm_corrupt_files}


def _strings(findings):
    return [str(f) for f in findings]


@pytest.mark.parametrize("case", sorted(LM_CASES))
def test_check_lm_findings_match_jax(tmp_path, case):
    root = make_lm_eval_tree(tmp_path, np.random.default_rng(0))
    if LM_CASES[case]:
        LM_CASES[case](root)
    want = _strings(jax_checkdata.check_lm(root, "ape"))
    assert _strings(checkdata.check_lm(root, "ape")) == want
    assert _strings(checkdata.check_lm(root, "ape", assets_only=True)) == \
        _strings(jax_checkdata.check_lm(root, "ape", assets_only=True))
    assert (case == "clean") == (not any("[ERROR]" in s for s in want))


def _lmo_tree(root, rng, stray=False, assets=False):
    from PIL import Image

    occ = root / "OCCLUSION_LINEMOD"
    os.makedirs(occ / "RGB-D" / "rgb_noseg")
    os.makedirs(occ / "RGB-D" / "depth_noseg")
    os.makedirs(occ / "blender_poses" / "ape")
    img = (rng.uniform(size=(60, 80, 3)) * 255).astype(np.uint8)
    Image.fromarray(img).save(occ / "RGB-D" / "rgb_noseg"
                              / "color_00000.png")
    if stray:
        Image.fromarray(img).save(occ / "RGB-D" / "rgb_noseg"
                                  / "preview.png")
    depth = np.zeros((60, 80), np.uint16)
    depth[20:40, 30:50] = 800
    Image.fromarray(depth.astype(np.int32)).save(
        occ / "RGB-D" / "depth_noseg" / "depth_00000.png")
    pose = np.eye(3, 4, dtype=np.float64)
    pose[:, 3] = [0.0, 0.0, 0.8]
    np.save(occ / "blender_poses" / "ape" / "pose0.npy", pose)
    if assets:
        pv = root / "LINEMOD" / "ape"
        os.makedirs(pv)
        write_ascii_ply(str(pv / "ape.ply"),
                        rng.uniform(-0.05, 0.05, size=(500, 3)))
        np.save(pv / "Outside9.npy", rng.uniform(-0.1, 0.1, size=(9, 3)))


@pytest.mark.parametrize("case", ["clean", "no depth", "stray png",
                                  "assets", "assets without ply"])
def test_check_lmo_findings_match_jax(tmp_path, case):
    _lmo_tree(tmp_path, np.random.default_rng(1), stray=case == "stray png",
              assets=case.startswith("assets"))
    occ = tmp_path / "OCCLUSION_LINEMOD"
    if case == "no depth":
        os.remove(occ / "RGB-D" / "depth_noseg" / "depth_00000.png")
    if case == "assets without ply":
        os.remove(tmp_path / "LINEMOD" / "ape" / "ape.ply")
    root = str(tmp_path)
    assert _strings(checkdata.check_lmo(root, "ape")) == \
        _strings(jax_checkdata.check_lmo(root, "ape"))
    kw = dict(dataset="lmo", root_dataset=root, class_name="ape")
    got = checkdata.run_check(Config(**kw), progress=lambda *_: None)
    want = jax_checkdata.run_check(JaxConfig(**kw), progress=lambda *_: None)
    assert _strings(got) == _strings(want) and want


def _ycb_radial_mm(root):
    import h5py

    h5p = os.path.join(root, "002_master_chef_can.hdf5")
    with h5py.File(h5p, "a") as f:
        key = list(f["3Dradius_pt1_dm"].keys())[0]
        bad = np.asarray(f["3Dradius_pt1_dm"][key]) * 100.0
        del f["3Dradius_pt1_dm"][key]
        f["3Dradius_pt1_dm"].create_dataset(key, data=bad)


def _ycb_no_h5(root):
    os.remove(os.path.join(root, "002_master_chef_can.hdf5"))


def _ycb_mat_field(root):
    import scipy.io

    mat_p = os.path.join(root, "data", "0000", "000001.mat")
    meta = scipy.io.loadmat(mat_p)
    del meta["factor_depth"]
    scipy.io.savemat(mat_p, {k: v for k, v in meta.items()
                             if not k.startswith("__")})


def _ycb_split_mismatch(root):
    with open(os.path.join(root, "Split", "002_master_chef_can", "val.txt"),
              "w") as f:
        f.write("9999_999999\n")


YCB_CASES = {"clean": None, "radial mm": _ycb_radial_mm, "no hdf5": _ycb_no_h5,
             "mat field": _ycb_mat_field, "split mismatch": _ycb_split_mismatch}


@pytest.mark.parametrize("case", sorted(YCB_CASES))
def test_check_ycb_findings_match_jax(tmp_path, monkeypatch, case):
    """Through h5py and, with h5py hidden, through the port's own reader
    (which reads the gzip-chunked radial maps itself)."""
    make_ycb_eval_tree(tmp_path, np.random.default_rng(2), n_frames=1)
    root = str(tmp_path)
    if YCB_CASES[case]:
        YCB_CASES[case](root)
    want = _strings(jax_checkdata.check_ycb(root, "002_master_chef_can", 1))
    assert _strings(checkdata.check_ycb(root, "002_master_chef_can",
                                        1)) == want
    kw = dict(dataset="ycb", root_dataset=root,
              class_name="002_master_chef_can")
    run_want = _strings(jax_checkdata.run_check(JaxConfig(**kw),
                                                progress=lambda *_: None))
    monkeypatch.setitem(sys.modules, "h5py", None)
    assert _strings(checkdata.check_ycb(root, "002_master_chef_can",
                                        1)) == want
    assert _strings(checkdata.run_check(Config(**kw),
                                        progress=lambda *_: None)) == run_want
    assert (case == "clean") == (not any("[ERROR]" in s for s in want))
