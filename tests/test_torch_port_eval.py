"""The port's LINEMOD evaluator, ICP, metrics, readers and evaluation
checkpoints against the JAX package on the CPU.

Both packages read the same synthetic LINEMOD-layout trees
(``tests/test_eval_lm_format.py::make_lm_eval_tree``) and, on the network
route, the same ``.pth.tar`` files, written once by the JAX package's
``export_torch_checkpoint``. Pass rates are held exactly equal, per-frame
ADD scores within 1e-2 mm (f32 sums run in another order in each
framework).
"""

import dataclasses
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from rcvpose_tpu import checkpoint as jax_checkpoint
from rcvpose_tpu import eval as jax_eval
from rcvpose_tpu import fit as jax_fit
from rcvpose_tpu import metrics as jax_metrics
from rcvpose_tpu.config import Config as JaxConfig
from rcvpose_tpu.data import readers as jax_readers
from rcvpose_tpu_torch import checkpoint as port_checkpoint
from rcvpose_tpu_torch import eval as port_eval
from rcvpose_tpu_torch import fit as port_fit
from rcvpose_tpu_torch import metrics as port_metrics
from rcvpose_tpu_torch import train as port_train
from rcvpose_tpu_torch import utils as port_utils
from rcvpose_tpu_torch.config import Config
from rcvpose_tpu_torch.data import readers as port_readers
from rcvpose_tpu_torch.models import fcnresnet as fcn
from tests.test_data import write_ascii_ply, write_binary_ply, write_dpt
from tests.test_eval_lm_format import make_lm_eval_tree
from tests.torch_port_icp import icp_problem as _icp_problem
from tests.torch_port_icp import rot as _rot
from tests.torch_port_threads import port_threads  # noqa: F401

SCORE_ATOL_MM = 1e-2
# Small grids keep the evaluator cheap on the CPU.
EVAL_KW = dict(compute_dtype="float32", vote_grid_l=96, max_points=2048,
               vote_mode="hier", icp_iters=10, eval_data_parallel=False)
NET_KW = dict(model_blocks="1,1,1,1", model_width=0.125)


def _t(x):
    return torch.tensor(np.asarray(x, np.float32))


# ---------------------------------------------------------------------------
# Metrics and ICP
# ---------------------------------------------------------------------------

def test_metrics_match_jax():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(300, 3)).astype(np.float32) * 40.0
    b = rng.normal(size=(500, 3)).astype(np.float32) * 40.0
    mask = rng.uniform(size=500) < 0.7
    for m in (None, mask):
        want = jax_metrics.nn_distances(jnp.asarray(a), jnp.asarray(b),
                                        None if m is None else jnp.asarray(m))
        got = port_metrics.nn_distances(_t(a), _t(b),
                                        None if m is None else torch.tensor(m))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-4)
    rt_gt = np.concatenate([_rot([1, 2, 3], 0.3), [[5.0], [-3.0], [60.0]]],
                           axis=1).astype(np.float32)
    rt_est = rt_gt.copy()
    rt_est[:, 3] += [2.0, 1.0, -4.0]
    want = jax_metrics.add_score(jnp.asarray(a), jnp.asarray(rt_gt),
                                 jnp.asarray(rt_est))
    got = port_metrics.add_score(_t(a), _t(rt_gt), _t(rt_est))
    for g, w in zip(got, want):
        assert abs(float(g) - float(w)) <= 1e-4
    scores = rng.uniform(0, 30, size=50).astype(np.float32)
    assert float(port_metrics.add_accuracy(_t(scores), 14.2)) == float(
        jax_metrics.add_accuracy(jnp.asarray(scores), 14.2))
    d = rng.uniform(0, 0.12, size=200)
    assert port_metrics.auc_add(d) == jax_metrics.auc_add(d)
    grid = [0, 0.02, 0.04, 0.06, 0.08, 0.1]
    assert (port_metrics.auc_add(torch.tensor(d), thresholds=grid)
            == jax_metrics.auc_add(d, thresholds=grid))


@pytest.mark.parametrize("mode", ["fixed", "converged"])
def test_icp_point_to_point_matches_jax(mode):
    cad, target, mask, init = _icp_problem(5)
    # the RMSE settles at the noise; a 1e-4 mm tolerance stops the loop
    # before f32 rounding sets the count
    kw = dict(max_iters=30) if mode == "fixed" else dict(
        max_iters=50, rel_fitness=1e-6, rel_rmse=1e-4)
    want, want_it = jax_fit.icp_point_to_point(
        jnp.asarray(cad), jnp.asarray(target), jnp.asarray(mask),
        jnp.asarray(init), 6.0, return_iters=True, **kw)
    got, got_it = port_fit.icp_point_to_point(
        _t(cad), _t(target), torch.tensor(mask), _t(init), 6.0,
        return_iters=True, **kw)
    want = np.asarray(want)
    assert got_it == int(want_it)
    if mode == "converged":
        assert 1 < got_it < 50
    np.testing.assert_allclose(got[:3, :3].numpy(), want[:3, :3], rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(got[:3, 3].numpy(), want[:3, 3], rtol=0,
                               atol=1e-2)
    # without return_iters: the transform alone, unchanged
    again = port_fit.icp_point_to_point(_t(cad), _t(target),
                                        torch.tensor(mask), _t(init), 6.0,
                                        **kw)
    assert torch.equal(again, got)


def test_icp_keeps_the_pose_with_fewer_than_three_correspondences():
    cad, target, mask, init = _icp_problem(4)
    init = init.copy()
    init[:3, 3] += 500.0  # nothing within the threshold
    got = port_fit.icp_point_to_point(_t(cad), _t(target), torch.tensor(mask),
                                      _t(init), 1.0, max_iters=5)
    assert torch.equal(got, _t(init))


# ---------------------------------------------------------------------------
# Readers
# ---------------------------------------------------------------------------

def test_readers_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    depth = rng.integers(0, 2000, size=(12, 17)).astype(np.uint16)
    write_dpt(str(tmp_path / "d.dpt"), depth)
    img = rng.integers(0, 256, size=(12, 17, 3), dtype=np.uint8)
    Image.fromarray(img).save(tmp_path / "i.png")
    Image.fromarray(img).save(tmp_path / "i.jpg")
    Image.fromarray(depth).save(tmp_path / "d.png")
    pts = rng.normal(size=(40, 3)).astype(np.float32)
    write_ascii_ply(str(tmp_path / "a.ply"), pts)
    write_binary_ply(str(tmp_path / "b.ply"), pts)
    (tmp_path / "r.rot").write_text("3 3\n" + " ".join(
        str(x) for x in _rot([1, 0, 1], 0.2).reshape(-1)) + "\n")
    (tmp_path / "t.tra").write_text("3 1\n1.5 -2.0 75.0\n")
    for name in ("d.dpt", "d.png"):
        np.testing.assert_array_equal(
            port_readers.read_depth(tmp_path / name),
            jax_readers.read_depth(tmp_path / name))
    for name in ("i.png", "i.jpg"):
        np.testing.assert_array_equal(
            port_readers.read_image(tmp_path / name),
            jax_readers.read_image(tmp_path / name))
        np.testing.assert_array_equal(
            port_readers.read_mask(tmp_path / name),
            jax_readers.read_mask(tmp_path / name))
    for name in ("a.ply", "b.ply"):
        np.testing.assert_array_equal(
            port_readers.read_ply_points(tmp_path / name),
            jax_readers.read_ply_points(tmp_path / name))
    np.testing.assert_array_equal(
        port_readers.read_rot_tra_pose(tmp_path / "r.rot",
                                       tmp_path / "t.tra"),
        jax_readers.read_rot_tra_pose(tmp_path / "r.rot", tmp_path / "t.tra"))
    np.testing.assert_array_equal(port_readers.dispersed_keypoints(pts),
                                  jax_readers.dispersed_keypoints(pts))


def _h5_file(path, names, **kw):
    import h5py

    with h5py.File(path, "w", **kw) as f:
        for name in names:
            f.create_dataset(f"JPEGImages/{name}", data=np.zeros(1, np.uint8))
        f.create_group("JPEGImages/zz_group")
        f.create_dataset("3Dradius_pt1_dm/0000_000001",
                         data=np.zeros((4, 4), np.float32), compression="gzip")


@pytest.mark.parametrize("n", [3, 3000])
def test_hdf5_group_keys_without_h5py_match_h5py(tmp_path, monkeypatch, n):
    """The port's own HDF5 name reader against h5py, on files as h5py
    writes them by default: shuffled inserts, a subgroup, a multi-level
    B-tree (3000 names), the root group listed from its object header
    when its entry caches nothing; a newer layout is refused."""
    import sys

    rng = np.random.default_rng(n)
    names = [f"{i // 1000:04d}_{i % 1000 + 1:06d}" for i in rng.permutation(n)]
    path = tmp_path / "a.hdf5"
    _h5_file(path, names)
    want = port_readers.hdf5_group_keys(path, "JPEGImages")
    assert want == sorted(names) + ["zz_group"]
    root_want = port_readers.hdf5_group_keys(path, "/")
    monkeypatch.setitem(sys.modules, "h5py", None)
    assert port_readers.hdf5_group_keys(path, "JPEGImages") == want
    assert port_readers.hdf5_group_keys(path, "/") == root_want == [
        "3Dradius_pt1_dm", "JPEGImages"]
    assert port_readers.hdf5_group_keys(path, "3Dradius_pt1_dm") == [
        "0000_000001"]
    with pytest.raises(KeyError, match="nope"):
        port_readers.hdf5_group_keys(path, "nope")
    # the root entry's cache type (superblock v0: entry at 56, 8-byte
    # offsets) set to 0: the names come from the root's object header
    data = bytearray(path.read_bytes())
    assert data[56 + 16] == 1
    data[56 + 16] = 0
    (tmp_path / "b.hdf5").write_bytes(bytes(data))
    assert port_readers.hdf5_group_keys(tmp_path / "b.hdf5",
                                        "JPEGImages") == want


def test_hdf5_group_keys_refuses_newer_layouts(tmp_path, monkeypatch):
    import sys

    _h5_file(tmp_path / "c.hdf5", ["0000_000001"], libver="latest")
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ValueError, match="h5py"):
        port_readers.hdf5_group_keys(tmp_path / "c.hdf5", "JPEGImages")
    (tmp_path / "d.hdf5").write_bytes(b"not hdf5")
    with pytest.raises(ValueError, match="h5py"):
        port_readers.hdf5_group_keys(tmp_path / "d.hdf5", "JPEGImages")


def test_chip_smoke_ycb_name_list_reads_without_h5py(tmp_path, monkeypatch):
    """The YCB ``.hdf5`` that ``chip_smoke.py`` writes on the card (whose
    machine has no h5py) lists its four frames in h5py and in the port's
    own reader."""
    import base64
    import sys
    import zlib

    import chip_smoke

    path = tmp_path / "k.hdf5"
    path.write_bytes(zlib.decompress(base64.b64decode(
        chip_smoke.YCB_KEYS_HDF5)))
    want = [f"0000_{i:06d}" for i in range(1, 5)]
    assert port_readers.hdf5_group_keys(path, "JPEGImages") == want
    monkeypatch.setitem(sys.modules, "h5py", None)
    assert port_readers.hdf5_group_keys(path, "JPEGImages") == want


def test_readers_without_pil_name_it(tmp_path, monkeypatch):
    depth = np.arange(12, dtype=np.uint16).reshape(3, 4)
    write_dpt(str(tmp_path / "d.dpt"), depth)
    Image.fromarray(depth).save(tmp_path / "d.png")
    monkeypatch.setitem(sys.modules, "PIL", None)
    np.testing.assert_array_equal(port_readers.read_depth(tmp_path / "d.dpt"),
                                  depth)
    for fn, name in ((port_readers.read_image, "d.png"),
                     (port_readers.read_mask, "d.png"),
                     (port_readers.read_depth, "d.png")):
        with pytest.raises(ImportError, match="PIL"):
            fn(tmp_path / name)


# ---------------------------------------------------------------------------
# Evaluation checkpoints
# ---------------------------------------------------------------------------

def _tiny_state_dict(seed=0):
    model = port_train.build_model(Config(**NET_KW))
    torch.manual_seed(seed)
    return model, {k: v + torch.randn_like(v.float()).to(v.dtype)
                   if v.is_floating_point() else v
                   for k, v in model.state_dict().items()}


def test_import_torch_checkpoint_layouts(tmp_path):
    model, sd = _tiny_state_dict()
    # reference payload, DataParallel prefixes, a dead projection and no
    # num_batches_tracked
    ref = {f"module.{k}": v for k, v in sd.items()
           if not k.endswith("num_batches_tracked")}
    ref["module.block1.0.upsample_.0.weight"] = torch.zeros(1)
    torch.save({"model_state_dict": ref, "epoch": 3}, tmp_path / "ref.pth.tar")
    torch.save(sd, tmp_path / "bare.pth.tar")
    for name in ("ref.pth.tar", "bare.pth.tar"):
        fresh = port_train.build_model(Config(**NET_KW))
        port_checkpoint.load_model_weights(
            fresh, port_checkpoint.import_torch_checkpoint(
                str(tmp_path / name)))
        for k, v in fresh.state_dict().items():
            if not k.endswith("num_batches_tracked"):
                assert torch.equal(v, sd[k]), k

    missing = dict(sd)
    missing.pop("conv8.bias")
    with pytest.raises(KeyError, match="conv8.bias"):
        port_checkpoint.load_model_weights(model, missing)
    extra = dict(sd, **{"conv9.weight": torch.zeros(1)})
    with pytest.raises(KeyError, match="conv9.weight"):
        port_checkpoint.load_model_weights(model, extra)


def test_import_checkpoint_dir_reads_port_then_orbax_and_names_both(
        tmp_path):
    """The directory branch of ``import_torch_checkpoint``: a port
    ``Checkpointer`` directory reads ``model_best.pth.tar`` before
    ``ckpt.pth.tar``; an orbax ``Checkpointer`` directory's ``model_best/``
    (written by orbax from the JAX package's import of the same weights) is
    read without orbax; a directory with neither raises naming both."""
    import orbax.checkpoint as ocp

    _, sd_ckpt = _tiny_state_dict(1)
    _, sd_best = _tiny_state_dict(2)
    ckdir = tmp_path / "cls_pt1"
    ckdir.mkdir()
    torch.save({"model_state_dict": sd_ckpt}, ckdir / "ckpt.pth.tar")
    got = port_checkpoint.import_torch_checkpoint(str(ckdir))
    assert torch.equal(got["conv8.weight"], sd_ckpt["conv8.weight"])
    torch.save({"model_state_dict": sd_best}, ckdir / "model_best.pth.tar")
    got = port_checkpoint.import_torch_checkpoint(str(ckdir))
    assert torch.equal(got["conv8.weight"], sd_best["conv8.weight"])

    orbax = tmp_path / "orbax_dir"
    variables = jax_checkpoint.import_torch_state_dict(
        {k: v.numpy() for k, v in sd_best.items()})
    saver = ocp.StandardCheckpointer()
    saver.save(str(orbax / "model_best"), variables)
    saver.wait_until_finished()
    got = port_checkpoint.import_torch_checkpoint(str(orbax))
    want = {k: v for k, v in sd_best.items()
            if not k.endswith("num_batches_tracked")}
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k

    neither = tmp_path / "neither"
    (neither / "model_best").mkdir(parents=True)
    with pytest.raises(ValueError, match="orbax") as err:
        port_checkpoint.import_torch_checkpoint(str(neither))
    assert "model_best.pth.tar" in str(err.value)


# ---------------------------------------------------------------------------
# The LINEMOD evaluator, both packages
# ---------------------------------------------------------------------------

def _jax_tiny_variables(seed):
    """A tiny net's Flax variables whose conv8 gives seg logits far above
    the sem threshold and radii near 0.9 dm with a 1e-3 dm ripple: sem
    passes on the object and every radius rounds to the same voxel count in
    both packages, while the maps still come from a real forward. Made by
    the port's seeded init and carried into Flax by the JAX package's
    importer (a Flax ``init`` costs tens of seconds here)."""
    model = fcn.init_params(port_train.build_model(Config(**NET_KW)),
                            torch.Generator().manual_seed(seed))
    with torch.no_grad():
        model.conv8.weight[1] *= 1e-3
        model.conv8.bias.copy_(torch.tensor([10.0, 0.9]))
    return jax_checkpoint.import_torch_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()})


@pytest.fixture(scope="module")
def lm_trees(tmp_path_factory):
    """The precomputed-map tree at 120x160 and the network tree at 128x160
    with three exported 3-net checkpoints."""
    pre = make_lm_eval_tree(tmp_path_factory.mktemp("pre"),
                            np.random.default_rng(0))
    net_root = tmp_path_factory.mktemp("net")
    net = make_lm_eval_tree(net_root, np.random.default_rng(1), h=128, w=160)
    ckpts = net_root / "ckpts"
    ckpts.mkdir()
    for i in range(1, 4):
        jax_checkpoint.export_torch_checkpoint(
            _jax_tiny_variables(i), str(ckpts / f"ape_pt{i}.pth.tar"))
    return {"pre": (pre, None), "net": (net, str(ckpts))}


def _cfgs(root, model_dir):
    kw = dict(EVAL_KW, root_dataset=root, using_ckpts=model_dir is not None)
    if model_dir is not None:
        kw.update(NET_KW, model_dir=model_dir)
    return JaxConfig(**kw), Config(**kw)


def _frame_scores(root, model_dir):
    """Per-frame (score_bf, score_af) of both packages' ``_frame_eval_seq``
    on every frame of the tree."""
    jcfg, pcfg = _cfgs(root, model_dir)
    jcfg = jax_eval._dataset_eval_cfg(jcfg)
    pcfg = port_eval._dataset_eval_cfg(pcfg)
    pv = f"{root}/LINEMOD/ape"
    cad_m = port_eval._read_eval_cad_m(f"{pv}/ape.ply")
    kpts = np.load(f"{pv}/Outside9.npy")
    max_radii = port_eval._per_kpt_max_radii_dm(cad_m, kpts)
    jsrc = jax_eval.RadialMapSource(jcfg, "ape")
    psrc = port_eval.RadialMapSource(pcfg, "ape", device="cpu")
    if model_dir is not None:
        jsrc.apply_fns, jsrc.params = jax_eval._load_models(jcfg, "ape")
        psrc.models = port_eval._load_models(pcfg, "ape", "cpu")
    k = jnp.asarray(jax_eval.geometry.LINEMOD_K, jnp.float32)
    out = []
    for i in range(2):
        fid = f"{i:06d}"
        rt_gt = np.load(f"{pv}/pose/pose{i}.npy")
        rt_gt_mm = rt_gt.copy()
        rt_gt_mm[:, 3] *= 1000.0
        depth = port_readers.read_depth(
            f"{root}/LINEMOD_ORIG/ape/data/depth{i}.dpt").astype(np.float32)
        image = port_readers.read_image(f"{pv}/JPEGImages/{fid}.jpg")
        common = (max_radii, pcfg.sem_threshold, kpts[1:4] * 1000.0)
        _, jbf, jaf, _, _ = jax_eval._frame_eval_seq(
            jcfg, jsrc, image, fid, jnp.asarray(depth), k, *common,
            jnp.asarray(cad_m * 1000.0, jnp.float32), rt_gt_mm, False,
            icp_iters=jcfg.icp_iters)
        _, pbf, paf, _, _ = port_eval._frame_eval_seq(
            pcfg, psrc, image, fid, torch.tensor(depth),
            torch.tensor(jax_eval.geometry.LINEMOD_K, dtype=torch.float32),
            *common, torch.tensor((cad_m * 1000.0).astype(np.float32)),
            rt_gt_mm, False, icp_iters=pcfg.icp_iters)
        out.append(((jbf, jaf), (pbf, paf)))
    return out


@pytest.mark.parametrize("route", ["pre", "net"])
def test_estimate_6d_pose_lm_matches_jax(lm_trees, route):
    root, model_dir = lm_trees[route]
    jcfg, pcfg = _cfgs(root, model_dir)
    want = jax_eval.estimate_6d_pose_lm(jcfg, class_names=["ape"],
                                        progress=lambda m: None)["ape"]
    lines = []
    got = port_eval.estimate_6d_pose_lm(pcfg, class_names=["ape"],
                                        progress=lines.append,
                                        device="cpu")["ape"]
    for key in ("frames", "overflow_frames", "overflow_after_retry",
                "add_before_icp", "add_after_icp", "vote_topk"):
        assert got[key] == want[key], (key, got, want)
    assert set(got) == set(want)
    assert got["frames"] == 2 and got["vote_topk"] == 64
    if route == "pre":  # perfect maps on a clean render
        assert got["add_before_icp"] == 1.0 and got["add_after_icp"] == 1.0
    assert any("ADD(s) of ape" in ln for ln in lines)
    for (jbf, jaf), (pbf, paf) in _frame_scores(root, model_dir):
        assert np.isfinite([pbf, paf]).all()
        assert abs(pbf - jbf) <= SCORE_ATOL_MM, (pbf, jbf)
        assert abs(paf - jaf) <= SCORE_ATOL_MM, (paf, jaf)


def test_keypoint_with_retry_matches_jax(lm_trees):
    """A grid too small for the frame overflows, fires the retry once and
    gives the JAX package's center at the retry grid."""
    root, _ = lm_trees["pre"]
    jcfg, pcfg = _cfgs(root, None)
    radial = np.load(f"{root}/LINEMOD_ORIG/estRadialMap/ape/Out_pt1_dm/"
                     "000000.npy").astype(np.float32)
    sem = (radial != 0).astype(np.float32)
    depth = port_readers.read_depth(
        f"{root}/LINEMOD_ORIG/ape/data/depth0.dpt").astype(np.float32)
    k = jax_eval.geometry.LINEMOD_K
    jcfg = dataclasses.replace(jcfg, vote_grid_l=32, retry_grid_l=96)
    pcfg = dataclasses.replace(pcfg, vote_grid_l=32, retry_grid_l=96)
    fired = []
    want = jax_eval.keypoint_with_retry(
        jcfg, jnp.asarray(sem), jnp.asarray(radial), jnp.asarray(depth),
        jnp.asarray(k, jnp.float32), jnp.float32(2.0), jnp.float32(0.8))
    got = port_eval.keypoint_with_retry(
        pcfg, _t(sem), _t(radial), _t(depth), _t(k), _t(2.0), _t(0.8),
        on_retry=lambda: fired.append(1))
    assert fired == [1]
    assert bool(got[1]) == bool(want[1])
    assert int(got[2]) == int(want[2])
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0,
                               atol=1e-3)
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))


def test_precomputed_route_decodes_no_image(lm_trees, monkeypatch):
    """The precomputed-map route never reads the JPEG (the JAX loop
    decodes it and drops it); the results are the same."""
    root, _ = lm_trees["pre"]

    def no_decode(path):
        raise AssertionError(f"decoded {path}")

    monkeypatch.setattr(port_readers, "read_image", no_decode)
    cfg = Config(**dict(EVAL_KW, root_dataset=root, using_ckpts=False))
    res = port_eval.estimate_6d_pose_lm(cfg, class_names=["ape"],
                                        progress=lambda m: None,
                                        device="cpu")["ape"]
    assert res["add_before_icp"] == 1.0 and res["frames"] == 2


def test_estimate_6d_pose_lm_needs_a_card_unless_told(lm_trees):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    root, _ = lm_trees["pre"]
    cfg = Config(**dict(EVAL_KW, root_dataset=root, using_ckpts=False))
    with pytest.raises(RuntimeError, match="CUDA"):
        port_eval.estimate_6d_pose_lm(cfg, class_names=["ape"],
                                      progress=lambda m: None)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_eval.RadialMapSource(cfg, "ape")


def test_stage_timers_accrue_per_stage():
    timers = port_utils.StageTimers()
    for _ in range(3):
        with timers.time("net", torch.device("cpu")):
            pass
    with timers.time("acc"):
        pass
    rep = timers.report()
    assert rep["net"]["count"] == 3 and rep["acc"]["count"] == 1
    assert rep["net"]["total_ms"] >= 0.0


def test_prefetched_chunks_cancel_on_abort():
    """An abandoned sweep stops its producer thread."""
    import threading
    import time

    loaded = []

    def load(it):
        loaded.append(it)
        return it

    before = threading.active_count()
    gen = port_eval._prefetched_chunks(list(range(50)), 1, load)
    n, padded, got = next(gen)
    assert (n, padded, got) == (1, [0], [0])
    gen.close()
    for _ in range(100):
        if threading.active_count() <= before:
            break
        time.sleep(0.02)
    assert threading.active_count() <= before
    assert len(loaded) < 50
    # a finished sweep pads its last chunk by repeating the last item
    chunks = list(port_eval._prefetched_chunks(list(range(5)), 2, load))
    assert chunks[-1] == (1, [4, 4], [4, 4])
