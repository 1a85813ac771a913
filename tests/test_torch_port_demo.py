"""The port's demo overlays and scene clouds against the JAX package's
``demo`` module on the CPU, and the files that each port evaluator writes
under ``demo_mode``.

Overlays are held pixel for pixel for the same pose (both project in f32
and round half to even); scene clouds to 1e-3 mm in position and exactly
in colour.
"""

import os

import numpy as np
import pytest
from PIL import Image

from rcvpose_tpu import demo as jax_demo
from rcvpose_tpu import geometry as jax_geometry
from rcvpose_tpu_torch import demo as port_demo
from rcvpose_tpu_torch import eval as port_eval
from rcvpose_tpu_torch.config import Config
from rcvpose_tpu_torch.data import readers as port_readers
from tests.test_eval_lm_format import make_lm_eval_tree
from tests.test_eval_lmo_ycb_format import (YCB_FIXTURE_CLASS,
                                            make_ycb_eval_tree)
from tests.test_geometry import random_pose
from tests.test_torch_port_eval_lmo_ycb import (EVAL_KW, LMO_FRAMES,
                                                LMO_UNPOSED, PortExactMaps,
                                                make_lmo_tree)
from tests.torch_port_threads import port_threads  # noqa: F401

K = np.array([[200.0, 0, 80], [0, 200.0, 60], [0, 0, 1]])


def _pose_mm(rng):
    rt = np.asarray(random_pose(rng))
    rt[:, 3] *= 1000.0
    return rt


def _ply_records(path):
    """The vertex records of a binary PLY that ``save_scene_ply`` wrote."""
    data = open(path, "rb").read()
    body = data[data.index(b"end_header\n") + len(b"end_header\n"):]
    return np.frombuffer(body, dtype=np.dtype(
        [("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
         ("red", "u1"), ("green", "u1"), ("blue", "u1")]))


@pytest.mark.parametrize("seed", range(4))
def test_draw_overlay_matches_jax(seed):
    rng = np.random.default_rng(seed)
    img = (rng.uniform(size=(120, 160, 3)) * 255).astype(np.uint8)
    cad_mm = rng.normal(size=(500, 3)) * 30.0
    rt = _pose_mm(rng)
    np.testing.assert_allclose(
        port_demo.project_points_to_pixels(cad_mm, rt, K),
        jax_demo.project_points_to_pixels(cad_mm, rt, K), rtol=0, atol=1e-3)
    for color in ((255, 0, 0), (0, 0, 255)):
        got = port_demo.draw_overlay(img, cad_mm, rt, K, color=color)
        want = jax_demo.draw_overlay(img, cad_mm, rt, K, color=color)
        np.testing.assert_array_equal(got, want)
        assert (got != img).any()   # the model lands in the frame


def test_save_demo_frame_matches_jax(tmp_path):
    """The overlay PNG (estimate red, GT blue) and the scene PLY: the same
    pixels, positions within 1e-3 mm and colours exact."""
    rng = np.random.default_rng(5)
    h, w = 120, 160
    img = (rng.uniform(size=(h, w, 3)) * 255).astype(np.uint8)
    depth = np.zeros((h, w), np.float32)
    depth[20:90, 30:140] = rng.uniform(500.0, 900.0, size=(70, 110))
    cad_mm = rng.normal(size=(400, 3)) * 30.0
    rt_est, rt_gt = _pose_mm(rng), _pose_mm(rng)
    paths = {}
    for name, mod in (("port", port_demo), ("jax", jax_demo)):
        paths[name] = mod.save_demo_frame(
            str(tmp_path / name), "000007", img, cad_mm, rt_est, K,
            rt_gt_mm=rt_gt, depth_mm=depth, scene_ply=True)
    assert os.path.basename(paths["port"]) == "000007_overlay.png"
    got = np.asarray(Image.open(paths["port"]))
    np.testing.assert_array_equal(got, np.asarray(Image.open(paths["jax"])))
    assert ((got == [255, 0, 0]).all(-1)).any()
    assert ((got == [0, 0, 255]).all(-1)).any()
    pg = _ply_records(tmp_path / "port" / "000007_scene.ply")
    pj = _ply_records(tmp_path / "jax" / "000007_scene.ply")
    assert len(pg) == len(pj) == int((depth > 0).sum())
    for c in ("x", "y", "z"):
        np.testing.assert_allclose(pg[c], pj[c], rtol=0, atol=1e-3)
    for c in ("red", "green", "blue"):
        np.testing.assert_array_equal(pg[c], pj[c])
    np.testing.assert_allclose(
        port_readers.read_ply_points(tmp_path / "port" / "000007_scene.ply"),
        np.stack([pj["x"], pj["y"], pj["z"]], 1), rtol=0, atol=1e-3)


def test_rgbd_to_color_point_cloud_matches_jax():
    rng = np.random.default_rng(2)
    h, w = 24, 32
    img = (rng.uniform(size=(h, w, 3)) * 255).astype(np.uint8)
    depth = np.zeros((h, w), np.float32)
    depth[4:20, 6:28] = rng.uniform(500, 900, size=(16, 22))
    k = np.array([[200.0, 0, 16], [0, 200.0, 12], [0, 0, 1]])
    got = port_demo.rgbd_to_color_point_cloud(k, depth, img)
    want = jax_demo.rgbd_to_color_point_cloud(k, depth, img)
    assert got.shape == want.shape == (16 * 22, 6)
    np.testing.assert_allclose(got[:, :3], want[:, :3], rtol=0, atol=1e-3)
    np.testing.assert_array_equal(got[:, 3:], want[:, 3:])


def test_save_demo_frame_writes_the_cloud_only_when_asked(tmp_path):
    rng = np.random.default_rng(1)
    img = np.zeros((32, 32, 3), np.uint8)
    depth = np.full((32, 32), 700.0, np.float32)
    cad_mm = rng.normal(size=(50, 3)) * 30.0
    port_demo.save_demo_frame(str(tmp_path), "f1", img, cad_mm,
                              _pose_mm(rng), K, depth_mm=depth,
                              scene_ply=True)
    assert (tmp_path / "f1_scene.ply").exists()
    port_demo.save_demo_frame(str(tmp_path), "f2", img, cad_mm,
                              _pose_mm(rng), K, depth_mm=depth)
    assert (tmp_path / "f2_overlay.png").exists()
    assert not (tmp_path / "f2_scene.ply").exists()


# ---------------------------------------------------------------------------
# demo_mode in the three evaluators
# ---------------------------------------------------------------------------

def _lm(root):
    make_lm_eval_tree(root, np.random.default_rng(0))
    pv = root / "LINEMOD" / "ape"
    frames = {}
    for i in range(2):
        pose = np.load(pv / "pose" / f"pose{i}.npy")
        img = port_readers.read_image(pv / "JPEGImages" / f"{i:06d}.jpg")
        frames[f"{i:06d}"] = (img, pose)
    cad_mm = port_readers.read_ply_points(pv / "ape.ply") * 1000.0
    run = dict(fn=port_eval.estimate_6d_pose_lm, class_names=["ape"])
    return run, "demo/ape", frames, cad_mm, jax_geometry.LINEMOD_K


def _lmo(root):
    posed = make_lmo_tree(root, np.random.default_rng(7))
    frames = {f"{n:05d}": (img, pose) for n, (img, _, pose) in posed.items()}
    assert len(frames) == len(LMO_FRAMES) - 1 and LMO_UNPOSED not in posed
    cad_mm = port_readers.read_ply_points(
        root / "LINEMOD" / "ape" / "ape.ply") * 1000.0
    run = dict(fn=port_eval.estimate_6d_pose_lmo, class_names=["ape"])
    return run, "demo_lmo/ape", frames, cad_mm, jax_geometry.LINEMOD_K


def _ycb(root):
    import scipy.io

    class_id, class_name = make_ycb_eval_tree(root, np.random.default_rng(3),
                                              n_frames=2)
    frames = {}
    for i in (1, 2):
        meta = scipy.io.loadmat(root / "data" / "0000" / f"{i:06d}.mat")
        img = port_readers.read_image(root / "data" / "0000"
                                      / f"{i:06d}-color.png")
        frames[f"0000_{i:06d}"] = (img, meta["poses"][:, :, 0])
        k = np.asarray(meta["intrinsic_matrix"], np.float32)
    cad_mm = np.loadtxt(root / "models" / class_name / "points.xyz") * 1000.0
    run = dict(fn=port_eval.estimate_6d_pose_ycb, class_ids=[class_id],
               map_source_factory=PortExactMaps)
    assert class_name == YCB_FIXTURE_CLASS[1]
    return run, f"demo_ycb/{class_name}", frames, cad_mm, k


@pytest.mark.parametrize("evaluator", [_lm, _lmo, _ycb],
                         ids=["lm", "lmo", "ycb"])
def test_evaluators_write_overlays_under_demo_mode(tmp_path, evaluator):
    """Every evaluated frame gets ``<frame>_overlay.png`` and, with
    ``demo_scene_ply``, ``<frame>_scene.ply`` under ``out_dir/<demo dir>/
    <class>``; the GT is painted blue exactly where the JAX package's
    ``draw_overlay`` puts it, and every other changed pixel is red."""
    run, sub, frames, cad_mm, k = evaluator(tmp_path)
    fn = run.pop("fn")
    cfg = Config(**dict(EVAL_KW, root_dataset=str(tmp_path),
                        using_ckpts=fn is port_eval.estimate_6d_pose_ycb,
                        dataset="ycb" if "ycb" in sub else "lm",
                        demo_mode=True, demo_scene_ply=True,
                        out_dir=str(tmp_path / "out")))
    fn(cfg, progress=lambda m: None, device="cpu", **run)
    out = tmp_path / "out" / sub
    assert sorted(os.listdir(out)) == sorted(
        f"{fid}_{kind}" for fid in frames
        for kind in ("overlay.png", "scene.ply"))
    for fid, (img, pose) in frames.items():
        overlay = np.asarray(Image.open(out / f"{fid}_overlay.png"))
        rt_gt = pose.copy()
        rt_gt[:, 3] *= 1000.0
        blue = (jax_demo.draw_overlay(np.zeros_like(img), cad_mm, rt_gt,
                                      np.asarray(k, np.float32),
                                      color=(0, 0, 255)) > 0).any(-1)
        assert blue.any()
        assert (overlay[blue] == [0, 0, 255]).all()
        changed = (overlay != img).any(-1) & ~blue
        assert (overlay[changed] == [255, 0, 0]).all()
