"""The port's data-parallel and process-sharded evaluation sweeps against
the JAX package's, on the CPU.

* LM (precomputed maps, three frames: the last chunk is padded), LMO
  (precomputed maps, a frame without a pose) and YCB (exact maps, a frame
  without the class) on the fixture trees of ``test_torch_port_eval.py``
  and ``test_torch_port_eval_lmo_ycb.py``: the port's sweep over a mesh of
  two CPU slots against the JAX sweep on a 2-device mesh (the same
  per-class keys and counts, per-frame scores within 1e-2 mm) and against
  the port's sequential sweep;
* two gloo processes against one process (LM ADD, YCB AUC), as
  ``scripts/multihost_eval_smoke.py`` does for the JAX package;
* the reduction of processes that took different paths, with a patched
  process count, as ``tests/test_multihost_eval.py`` does.

The rank worker is a module-level function that imports neither JAX nor
the JAX package: the spawned processes import this module.
"""

import os
from unittest import mock

import numpy as np
import pytest
import torch

from rcvpose_tpu_torch import eval as port_eval
from rcvpose_tpu_torch import parallel as port_parallel
from rcvpose_tpu_torch.config import Config
from rcvpose_tpu_torch.parallel import mesh as port_mesh
from tests.torch_port_threads import port_threads  # noqa: F401

CPU2 = (torch.device("cpu"),) * 2
SCORE_ATOL_MM = 1e-2
EVAL_KW = dict(compute_dtype="float32", vote_grid_l=96, max_points=2048,
               vote_mode="hier", icp_iters=5)
RANK_TIMEOUT = 180.0
# per-class keys whose values must agree exactly between the packages
COUNT_KEYS = ("add_before_icp", "add_after_icp", "frames", "overflow_frames",
              "overflow_after_retry", "vote_topk", "data_parallel",
              "adds_auc_before_icp", "adds_auc_after_icp")


class ExactMaps:
    """The YCB fixture's exact radial maps (``exact_radials/``) as CPU
    tensors: the evaluator's ``map_source_factory`` seam."""

    def __init__(self, cfg, class_name):
        self._dir = os.path.join(cfg.root_dataset, "exact_radials")

    def maps(self, kp, image_u8, frame_id, lmo=False):
        radial = np.load(os.path.join(self._dir, f"{frame_id}_pt{kp}.npy"))
        return (torch.from_numpy((radial != 0).astype(np.float32)),
                torch.from_numpy(radial.astype(np.float32)))


def _run(name, cfg, roots, progress=None, max_frames=None):
    """One port evaluator on the fixture tree of ``name``."""
    progress = progress or (lambda m: None)
    cfg = Config(**dict(cfg, root_dataset=roots[name][0]))
    kw = dict(progress=progress, max_frames=max_frames, device="cpu")
    if name == "lm":
        return port_eval.estimate_6d_pose_lm(cfg, class_names=["ape"],
                                             **kw)["ape"]
    if name == "lmo":
        return port_eval.estimate_6d_pose_lmo(cfg, class_names=["ape"],
                                              **kw)["ape"]
    return port_eval.estimate_6d_pose_ycb(
        cfg, class_ids=[roots[name][1]], map_source_factory=ExactMaps,
        **kw)["all"]


def _cfg(name, **kw):
    """Evaluator settings of ``name``'s tree. YCB runs its fixed-count ICP
    here (``ycb_icp_converged=False``): the converged one costs seconds a
    frame on the CPU and is the same ``refine_and_add`` on both paths
    (test_torch_port_eval_lmo_ycb.py holds it against the JAX package)."""
    base = dict(EVAL_KW, using_ckpts=name == "ycb", **kw)
    if name == "ycb":
        base.update(dataset="ycb", ycb_icp_converged=False)
    return base


def cli_test_argv(roots):
    """``--mode test --distributed`` on the LM tree's precomputed maps."""
    return ["--mode", "test", "--distributed", "--no_ckpts",
            "--root_dataset", roots["lm"][0], "--eval_classes", "ape",
            "--compute_dtype", "float32", "--vote_grid_l", "96",
            "--max_points", "2048", "--icp_iters", "5", "--out_dir",
            os.path.join(roots["lm"][0], "cli_out")]


def ranks_worker(rank, world, roots):
    """Every process sweeps its shard of the LM tree through ``cli.main
    --mode test --distributed`` (the world exists already) and of the YCB
    tree through the evaluator."""
    from rcvpose_tpu_torch import cli

    return {"lm": cli.main(cli_test_argv(roots), device="cpu")["ape"],
            "ycb": _run("ycb", _cfg("ycb", eval_data_parallel=False),
                        roots)}


# ---------------------------------------------------------------------------
# Trees and runs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """{name: (root, YCB class id or None)} of the three fixture trees."""
    from tests.test_eval_lm_format import make_lm_eval_tree
    from tests.test_eval_lmo_ycb_format import make_ycb_eval_tree
    from tests.test_torch_port_eval_lmo_ycb import _drop_class, make_lmo_tree

    lm = tmp_path_factory.mktemp("dp_lm")
    make_lm_eval_tree(lm, np.random.default_rng(0), n_frames=3)
    lmo = tmp_path_factory.mktemp("dp_lmo")
    make_lmo_tree(lmo, np.random.default_rng(7))
    ycb = tmp_path_factory.mktemp("dp_ycb")
    class_id, _ = make_ycb_eval_tree(ycb, np.random.default_rng(3),
                                     n_frames=3)
    _drop_class(str(ycb), "0000_000002")
    return {"lm": (str(lm), None), "lmo": (str(lmo), None),
            "ycb": (str(ycb), class_id)}


def _slots(n):
    """Patch the port's local devices on the CPU to ``n`` slots."""
    orig = port_mesh.local_devices

    def devices(device=None):
        if device is not None and torch.device(device).type == "cpu":
            return [torch.device("cpu")] * n
        return orig(device)

    return (mock.patch.object(port_mesh, "local_devices", devices),
            mock.patch.object(port_parallel, "local_devices", devices))


def _recording(module):
    """Patch ``module.sharded_frame_scores`` to record each chunk's
    per-frame scores; returns (rows, patch)."""
    rows = []
    orig = module.sharded_frame_scores

    def rec(*args, **kw):
        out = orig(*args, **kw)
        rows.extend(zip(np.asarray(out["score_bf"]).tolist(),
                        np.asarray(out["score_af"]).tolist()))
        return out

    return rows, mock.patch.object(module, "sharded_frame_scores", rec)


@pytest.fixture(scope="module")
def jax_dp(roots):
    """The JAX package's data-parallel sweeps on a 2-device mesh: {name:
    (results, per-frame (bf, af) rows of the chunks, padding included)}."""
    from rcvpose_tpu import eval as jax_eval
    from rcvpose_tpu import parallel as jax_parallel
    from rcvpose_tpu.config import Config as JaxConfig
    from tests.test_eval_lmo_ycb_format import ExactMapsFromDisk

    out = {}
    for name in ("lm", "lmo", "ycb"):
        cfg = JaxConfig(**dict(_cfg(name, eval_data_parallel=True),
                               root_dataset=roots[name][0]))
        rows, rec = _recording(jax_parallel)
        with rec, mock.patch.object(jax_eval, "_dp_mesh_or_none",
                                    lambda c: jax_parallel.data_mesh(2)):
            if name == "lm":
                res = jax_eval.estimate_6d_pose_lm(
                    cfg, class_names=["ape"], progress=lambda m: None)["ape"]
            elif name == "lmo":
                res = jax_eval.estimate_6d_pose_lmo(
                    cfg, class_names=["ape"], progress=lambda m: None)["ape"]
            else:
                res = jax_eval.estimate_6d_pose_ycb(
                    cfg, class_ids=[roots[name][1]], progress=lambda m: None,
                    map_source_factory=ExactMapsFromDisk)["all"]
        out[name] = (res, rows)
    return out


@pytest.fixture(scope="module")
def port_runs(roots, tmp_path_factory):
    """The port's sweeps: {"dp": {name: (results, rows, progress lines)},
    "seq": {name: results}, "demo": LM DP overlay directory}."""
    demo = str(tmp_path_factory.mktemp("dp_demo"))
    dp, seq = {}, {}
    for name in ("lm", "lmo", "ycb"):
        rows, rec = _recording(port_parallel)
        lines = []
        extra = (dict(demo_mode=True, out_dir=demo) if name == "lm" else {})
        p1, p2 = _slots(2)
        with rec, p1, p2:
            res = _run(name, _cfg(name, eval_data_parallel=True, **extra),
                       roots, lines.append)
        dp[name] = (res, rows, lines)
        seq[name] = _run(name, _cfg(name, eval_data_parallel=False), roots)
    return {"dp": dp, "seq": seq, "demo": demo}


# ---------------------------------------------------------------------------
# One process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["lm", "lmo", "ycb"])
def test_dp_sweep_matches_jax_dp_sweep(jax_dp, port_runs, name):
    """The port over two CPU slots against the JAX package on two
    devices: the same per-class keys, the same counts and rates, and the
    same per-frame scores (padded frames included) within 1e-2 mm."""
    want, want_rows = jax_dp[name]
    got, got_rows, _ = port_runs["dp"][name]
    assert sorted(got) == sorted(want)
    for key in COUNT_KEYS:
        if key in want:
            assert got[key] == pytest.approx(want[key], abs=1e-6), key
    assert got["data_parallel"] == 2 and got["frame_ms_per_frame"] > 0
    assert len(got_rows) == len(want_rows) >= 2
    np.testing.assert_allclose(np.asarray(got_rows), np.asarray(want_rows),
                               rtol=0, atol=SCORE_ATOL_MM)


@pytest.mark.parametrize("name", ["lm", "lmo", "ycb"])
def test_dp_sweep_matches_sequential_sweep(port_runs, name):
    got, rows, lines = port_runs["dp"][name]
    seq = port_runs["seq"][name]
    for key in ("add_before_icp", "add_after_icp", "frames",
                "adds_auc_before_icp", "adds_auc_after_icp"):
        if key in seq:
            assert got[key] == pytest.approx(seq[key], abs=1e-6), key
    assert "net_ms_per_frame" in seq and "net_ms_per_frame" not in got
    assert any("data-parallel frame program" in ln for ln in lines)
    if name == "lm":   # three frames over two slots: one padded row
        assert got["frames"] == 3 and len(rows) == 4
        assert rows[3] == rows[2]


def test_dp_sweep_writes_overlays(port_runs):
    assert sorted(os.listdir(os.path.join(port_runs["demo"], "demo",
                                          "ape"))) == [
        "000000_overlay.png", "000001_overlay.png", "000002_overlay.png"]


def test_dp_mesh_rules(monkeypatch):
    """Auto picks the data-parallel sweep with more than one local
    device; an explicit request on one device raises the JAX package's
    ValueError; under several processes the mesh is the process's own,
    and one local device sweeps its shard sequentially."""
    auto, on, off = (Config(eval_data_parallel=v) for v in (None, True,
                                                            False))
    assert port_eval._dp_mesh_or_none(auto, "cpu") is None
    assert port_eval._dp_mesh_or_none(off, "cpu") is None
    with pytest.raises(ValueError, match="only 1 device"):
        port_eval._dp_mesh_or_none(on, "cpu")
    p1, p2 = _slots(2)
    with p1, p2:
        mesh = port_eval._dp_mesh_or_none(auto, "cpu")
        assert mesh.devices == CPU2 and mesh.group is None
        assert port_eval._dp_mesh_or_none(off, "cpu") is None
        monkeypatch.setattr(port_parallel, "process_count", lambda: 2)
        assert port_eval._dp_mesh_or_none(on, "cpu").size == 2
    assert port_eval._dp_mesh_or_none(on, "cpu") is None


def test_proc_shard_and_finalize(monkeypatch):
    """One process: ``_proc_shard`` is the identity and
    ``_finalize_class_results`` only strips the raw counters. Two: the
    rank's round-robin slice."""
    items = list(range(5))
    assert port_eval._proc_shard(items) == items
    res = port_eval._finalize_class_results({
        "add_before_icp": 0.5, "add_after_icp": 1.0, "frames": 2,
        "bf_count": 1, "af_count": 2, "net_total_ms": 10.0,
        "acc_total_ms": 20.0, "decode_total_ms": 1.0,
        "net_ms_per_frame": 5.0, "acc_ms_per_frame": 10.0,
        "decode_ms_per_frame_overlapped": 0.5, "vote_topk": 64})
    assert res["add_before_icp"] == 0.5
    assert "bf_count" not in res and "net_total_ms" not in res
    assert "eval_processes" not in res
    monkeypatch.setattr(port_parallel, "process_count", lambda: 2)
    monkeypatch.setattr(port_parallel, "process_index", lambda: 1)
    assert port_eval._proc_shard(items) == [1, 3]


# ---------------------------------------------------------------------------
# Processes
# ---------------------------------------------------------------------------

RAW = ["bf_count", "af_count", "frames", "overflow_frames",
       "overflow_after_retry", "frame_total_ms", "net_total_ms",
       "acc_total_ms", "decode_total_ms", "data_parallel"]


def test_heterogeneous_path_reduction_uses_fixed_keys(monkeypatch):
    """This process swept sequentially, the other one data-parallel: the
    reduction runs over the fixed key layout with a presence mask, so
    the two paths' raw keys never mix (``tests/test_multihost_eval.py``'s
    case, with the same numbers)."""
    res_local = {"bf_count": 3, "af_count": 4, "frames": 5,
                 "net_total_ms": 50.0, "acc_total_ms": 25.0,
                 "decode_total_ms": 10.0, "add_before_icp": 0.6,
                 "add_after_icp": 0.8, "vote_topk": 64}
    res_remote = {"bf_count": 2, "af_count": 3, "frames": 3,
                  "overflow_frames": 1, "overflow_after_retry": 1,
                  "frame_total_ms": 90.0, "decode_total_ms": 6.0,
                  "data_parallel": 8}

    def fake_allgather(vec):
        remote = np.array([float(res_remote.get(k, 0.0)) for k in RAW]
                          + [1.0 if k in res_remote else 0.0 for k in RAW],
                          np.float32)
        assert vec.shape == remote.shape, "reduction layout must be fixed"
        return np.stack([np.asarray(vec), remote])

    monkeypatch.setattr(port_parallel, "process_count", lambda: 2)
    monkeypatch.setattr(port_parallel, "host_allgather", fake_allgather)
    out = port_eval._finalize_class_results(res_local)
    assert out["frames"] == 8
    assert out["add_before_icp"] == (3 + 2) / 8
    assert out["add_after_icp"] == (4 + 3) / 8
    assert out["overflow_frames"] == 1
    assert out["overflow_after_retry"] == 1
    assert out["data_parallel"] == 8
    assert out["net_ms_per_frame"] == 50.0 / 8
    assert out["acc_ms_per_frame"] == 25.0 / 8
    assert out["frame_ms_per_frame"] == 90.0 / 8
    assert out["decode_ms_per_frame_overlapped"] == 16.0 / 8
    assert out["eval_processes"] == 2


def test_ycb_heterogeneous_path_reduction(roots, monkeypatch):
    """The YCB tail reduces the paths' presence: this process sweeps
    sequentially, a faked remote one swept one frame data-parallel on 8
    cards; every process reports the union of the keys over the global
    frame count (``tests/test_multihost_eval.py``'s case)."""
    remote_scores = [np.array([5.0], np.float32),
                     np.array([4.0], np.float32)]
    remote_vec = np.array([1, 1, 1, 120.0, 0.0, 0.0, 4.0, 1.0, 8.0, 0.0],
                          np.float32)
    seen = {"vecs": [], "scores": []}

    def fake_allgather(vec):
        vec = np.asarray(vec, np.float32)
        assert vec.shape == remote_vec.shape
        seen["vecs"].append(vec.copy())
        return np.stack([vec, remote_vec])

    def fake_concat(lst):
        arr = np.asarray(lst, np.float32)
        seen["scores"].append(arr.copy())
        return np.concatenate([arr, remote_scores[len(seen["scores"]) - 1]])

    monkeypatch.setattr(port_parallel, "process_count", lambda: 2)
    monkeypatch.setattr(port_parallel, "host_allgather", fake_allgather)
    monkeypatch.setattr(port_parallel, "host_allgather_concat", fake_concat)
    res = _run("ycb", _cfg("ycb", eval_data_parallel=False), roots,
               max_frames=1)
    local = seen["vecs"][0]
    assert local[7] == 0 and local[9] == 1      # this process: sequential
    tot = local + remote_vec
    assert res["frames"] == 2 and res["eval_processes"] == 2
    assert res["data_parallel"] == 8
    assert res["frame_ms_per_frame"] == tot[3] / 2
    assert res["net_ms_per_frame"] == tot[4] / 2
    assert res["acc_ms_per_frame"] == tot[5] / 2
    assert res["add_before_icp"] == tot[0] / 2


@pytest.fixture(scope="module")
def two_processes(roots):
    return port_parallel.run_ranks(ranks_worker, 2, (roots,),
                                   timeout=RANK_TIMEOUT)


@pytest.mark.parametrize("name", ["lm", "ycb"])
def test_two_processes_match_one_process(two_processes, port_runs, name):
    """Two gloo processes sweeping disjoint shards (LM through ``cli.main
    --distributed``) report, on both ranks, the single process's
    per-class results."""
    one = port_runs["seq"][name]
    for rank in two_processes:
        got = rank[name]
        assert got["eval_processes"] == 2
        for key in ("frames", "add_before_icp", "add_after_icp",
                    "adds_auc_before_icp", "adds_auc_after_icp"):
            if key in one:
                assert got[key] == pytest.approx(one[key], abs=1e-6), key
        assert sorted(set(got) - {"eval_processes"}) == sorted(one)


def test_cli_test_distributed_writes_once(two_processes, port_runs, roots):
    """``cli.main --mode test --distributed`` in a two-process world: each
    process sweeps its shard sequentially (one device each), both hold the
    global results, and rank 0 alone writes ``eval_results.json``."""
    import json

    one = port_runs["seq"]["lm"]
    out_dir = cli_test_argv(roots)[-1]
    assert os.listdir(out_dir) == ["eval_results.json"]
    with open(os.path.join(out_dir, "eval_results.json")) as f:
        written = json.load(f)["ape"]
    for rank in two_processes:
        got = rank["lm"]
        assert got["eval_processes"] == 2 and "net_ms_per_frame" in got
        for key in ("frames", "add_before_icp", "add_after_icp"):
            assert got[key] == one[key] == written[key], key
