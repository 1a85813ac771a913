"""The port's command line against the JAX package's, on the CPU.

The parsers give the same ``Config`` for the same flags; ``get_log_dir``
writes the same ``config.json``; ``run_train`` trains from a fixture tree
on disk, checkpoints and resumes; two steps through the port's
``make_loaders`` + ``Trainer`` equal two steps of the JAX ``Trainer`` on
the same tree from the same weights, within ``test_torch_port_train.py``'s
update bounds (``UPDATE_REL`` of the largest update, ``UPDATE_REL_EACH``
of a parameter's own); gen-labels takes both roots; export-torch writes a
file ``import_torch_checkpoint`` reads; ``--mode benchmark`` runs the
port's bench; what the port does not run raises.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from rcvpose_tpu import cli as jax_cli
from rcvpose_tpu import parallel as jax_parallel
from rcvpose_tpu import train as jax_train
from rcvpose_tpu import utils as jax_utils
from rcvpose_tpu.data import loader as jax_loader
from rcvpose_tpu_torch import checkpoint, cli, train, utils
from rcvpose_tpu_torch.data import loader
from tests.test_data import make_linemod_tree
from tests.test_torch_port_train import _assert_updates, _np_tree, _params

TINY = ["--model_blocks", "1,1,1,1", "--model_width", "0.125",
        "--compute_dtype", "float32"]

FLAG_SETS = [
    [],
    ["--mode", "test", "--dname", "lmo", "--no_ckpts", "--vote_grid_l", "96",
     "--optim", "SGD", "--distributed"],
    ["--mode", "train", "--class_name", "cat", "--batch_size", "16",
     "--kpt_num", "2", "--remat", "--resume_train", "--accum_steps", "2",
     "--seed", "7", "--log_interval", "3"],
    ["--dataset", "ycb", "--eval_classes", "002_master_chef_can",
     "--no_eval_data_parallel", "--no_ycb_icp_converged", "--fake_depth",
     "--export_path", "x.pth.tar", "--profile_dir", "p", "--test_occ",
     "--vote_topk", "64", "--kpt_heads", "3", "--fast_head"],
]


@pytest.mark.parametrize("argv", FLAG_SETS)
def test_config_from_args_matches_jax(argv):
    got = dataclasses.asdict(cli.config_from_args(argv))
    want = dataclasses.asdict(jax_cli.config_from_args(argv))
    assert got == want
    assert sorted(a.dest for a in cli.build_parser()._actions) == \
        sorted(a.dest for a in jax_cli.build_parser()._actions)


def test_get_log_dir_writes_the_jax_config_json(tmp_path):
    argv = ["--class_name", "cat", "--kpt_num", "3", "--dname", "lmo",
            "--out_dir", str(tmp_path / "logs")]
    want_dir = jax_utils.get_log_dir(jax_cli.config_from_args(argv))
    with open(os.path.join(want_dir, "config.json")) as f:
        want = f.read()
    os.remove(os.path.join(want_dir, "config.json"))
    got_dir = utils.get_log_dir(cli.config_from_args(argv))
    assert got_dir == want_dir == str(tmp_path / "logs" / "lmo" / "catKp3")
    with open(os.path.join(got_dir, "config.json")) as f:
        assert f.read() == want


def _labelled_tree(tmp_path, n_frames, h=32, w=64):
    """The fixture tree with poses that put keypoint 1 in front of the
    frame's centre at about 0.7 m, so that the radial labels are not all
    zero."""
    from rcvpose_tpu_torch import geometry

    root = make_linemod_tree(tmp_path, np.random.default_rng(0), h=h, w=w,
                             n_frames=n_frames)
    base = os.path.join(root, "toy")
    k = geometry.LINEMOD_K
    kpt = np.load(os.path.join(base, "Outside9.npy"))[1]
    for i in range(n_frames):
        z = 0.7 + 0.02 * i
        centre = np.array([(w / 2 - k[0, 2]) * z / k[0, 0],
                           (h / 2 - k[1, 2]) * z / k[1, 1], z])
        np.save(os.path.join(base, "pose", f"pose{i}.npy"),
                np.concatenate([np.eye(3), (centre - kpt)[:, None]], axis=1))
    return root


def test_run_train_checkpoints_and_resumes(tmp_path):
    root = _labelled_tree(tmp_path, 3)
    args = ["--mode", "train", "--root_dataset", root, "--class_name", "toy",
            "--batch_size", "2", "--max_iterations", "2",
            "--out_dir", str(tmp_path / "logs"), *TINY]
    cfg = cli.config_from_args(args)
    trainer = cli.run_train(cfg, device="cpu")
    assert trainer.iteration == 2 and trainer.state.step == 2
    ckpt_dir = os.path.join(utils.get_log_dir(cfg), "ckpts")
    for name in ("ckpt.pth.tar", "model_best.pth.tar"):
        assert os.path.isfile(os.path.join(ckpt_dir, name))
    resumed = cli.run_train(cli.config_from_args(
        args + ["--resume_train", "--max_iterations", "3"]), device="cpu")
    assert resumed.iteration == 3 and resumed.state.step == 3

    # export-torch: model_best's weights, readable by the evaluators' reader
    out = str(tmp_path / "exported.pth.tar")
    cli.main(["--mode", "export-torch", "--model_dir", ckpt_dir,
              "--export_path", out])
    payload = torch.load(out, weights_only=True)
    assert set(payload) == {"model_state_dict", "epoch", "iteration", "arch"}
    best = torch.load(os.path.join(ckpt_dir, "model_best.pth.tar"),
                      weights_only=True)
    assert payload["iteration"] == best["iteration"] >= 1
    assert payload["epoch"] == best["epoch"]
    sd = checkpoint.import_torch_checkpoint(out)
    model = train.build_model(cfg)
    checkpoint.load_model_weights(model, sd)
    for key, val in best["model_state_dict"].items():
        torch.testing.assert_close(sd[key], val, rtol=0, atol=0)


def test_two_cli_path_steps_match_the_jax_trainer(tmp_path):
    """``make_loaders`` + ``Trainer`` as ``run_train`` wires them, two SGD
    steps from the JAX initialization, against the JAX ``make_loaders`` +
    ``Trainer`` on the same tree."""
    root = _labelled_tree(tmp_path, 4)
    argv = ["--root_dataset", root, "--class_name", "toy", "--batch_size",
            "2", "--max_iterations", "2", "--optim", "sgd", "--initial_lr",
            "1e-3", "--seed", "3", "--mode", "train", *TINY]
    jcfg = jax_cli.config_from_args(argv)
    jcfg.image_height, jcfg.image_width = 32, 64
    cfg = cli.config_from_args(argv)
    cfg.image_height, cfg.image_width = 32, 64

    jtrain, _ = jax_loader.make_loaders(jcfg, shard_rank=0, shard_count=1)
    state = jax_train.create_state(jcfg, jax.random.PRNGKey(0),
                                   steps_per_epoch=len(jtrain),
                                   sample_shape=(1, 32, 64, 3))
    init = {"params": _np_tree(state.params),
            "batch_stats": _np_tree(state.batch_stats)}
    jt = jax_train.Trainer(
        cfg=jcfg, state=state, mesh=jax_parallel.data_mesh(1),
        train_batches=lambda epoch, start_batch=0: jtrain.batches(
            epoch, start_batch),
        val_batches=lambda: iter(()), steps_per_epoch=len(jtrain))
    jt.fit(1)
    after = {"params": _np_tree(jt.state.params),
             "batch_stats": _np_tree(jt.state.batch_stats)}

    ptrain, _ = loader.make_loaders(cfg, device="cpu")
    assert len(ptrain) == len(jtrain) == 2
    pstate = train.create_state(cfg, torch.Generator().manual_seed(3),
                                steps_per_epoch=len(ptrain), device="cpu")
    pstate.model.load_state_dict(checkpoint.from_flax_variables(init))
    before = _params(pstate.model)
    pt = train.Trainer(
        cfg=cfg, state=pstate,
        train_batches=lambda epoch, start_batch=0: ptrain.batches(
            epoch, start_batch),
        val_batches=lambda: iter(()), steps_per_epoch=len(ptrain))
    pt.fit(1)
    assert pt.iteration == jt.iteration == 2
    assert ptrain.stats["batches"] == 2
    _assert_updates(before, _params(pt.state.model),
                    checkpoint.from_flax_variables(init),
                    checkpoint.from_flax_variables(after))


def test_run_gen_labels_accepts_both_roots(tmp_path):
    lm_root = make_linemod_tree(tmp_path, np.random.default_rng(1))
    for root in (str(tmp_path), lm_root):
        cfg = cli.config_from_args(["--mode", "gen-labels", "--root_dataset",
                                    root, "--class_name", "toy"])
        cli.run_gen_labels(cfg, device="cpu")
        out = os.path.join(lm_root, "toy", "Out_pt1_dm")
        assert sorted(os.listdir(out)) == ["000000.npy", "000001.npy",
                                           "000002.npy"]
        assert np.load(os.path.join(out, "000000.npy")).shape == (48, 64)
        for kp in (1, 2, 3):
            os.remove(os.path.join(lm_root, "toy", f"Out_pt{kp}_dm",
                                   "000000.npy"))
    cli.main(["--mode", "gen-labels", "--root_dataset", lm_root,
              "--class_name", "toy", "--fake_depth", "--kpt_num", "2"],
             device="cpu")
    assert len(os.listdir(os.path.join(lm_root, "toy", "FakeDepth"))) == 3


def test_main_test_mode_writes_results_json_and_profile(tmp_path,
                                                        monkeypatch):
    canned = {"ape": {"frames": 2, "add_after_icp": np.float32(1.0)}}
    seen = {}

    def fake_test(cfg, device=None):
        seen["device"] = device
        torch.ones(3).sum()
        return canned

    monkeypatch.setattr(cli, "run_test", fake_test)
    out_dir, prof = str(tmp_path / "logs"), str(tmp_path / "prof")
    cli.main(["--mode", "test", "--out_dir", out_dir, "--profile_dir", prof],
             device="cpu")
    with open(os.path.join(out_dir, "eval_results.json")) as f:
        assert json.load(f) == {"ape": {"frames": 2, "add_after_icp": 1.0}}
    assert seen["device"] == "cpu"
    traces = os.listdir(prof)
    assert len(traces) == 1 and traces[0].endswith(".json")


def test_benchmark_mode_runs_the_port_bench(monkeypatch):
    from rcvpose_tpu_torch import bench

    seen = []

    def fake_main(argv=None, device=None):
        seen.append((argv, device))
        return {"metric": "rgbd_frames_per_sec_per_chip"}

    monkeypatch.setattr(bench, "main", fake_main)
    out = cli.main(["--mode", "benchmark"], device="cpu")
    assert seen == [([], "cpu")]
    assert out == {"metric": "rgbd_frames_per_sec_per_chip"}


@pytest.mark.parametrize("argv,env,exc,match", [
    (["--mode", "train"], {"RCVPOSE_PALLAS_CONV": "auto"}, ValueError,
     "auto"),
    (["--mode", "train"], {"RCVPOSE_PALLAS_CONV": "interpret"}, ValueError,
     "interpret"),
])
def test_what_the_port_does_not_run_raises(monkeypatch, tmp_path, argv, env,
                                           exc, match):
    for key, val in env.items():
        monkeypatch.setenv(key, val)
    with pytest.raises(exc, match=match):
        cli.main(argv + ["--out_dir", str(tmp_path)], device="cpu")


def test_compile_cache_dir_sets_the_kernel_library_directory(
        monkeypatch, tmp_path):
    """``--compile_cache_dir`` points ``_build``'s library directory (and
    the native readers') at the named directory before the mode runs, as
    the JAX CLI points XLA's cache."""
    from rcvpose_tpu_torch import native
    from rcvpose_tpu_torch.ops import _build

    for mod in (_build, native):
        monkeypatch.setattr(mod, "BUILD_DIR", mod.BUILD_DIR)
        monkeypatch.setattr(mod, "_loaded_from", {})
    seen = []
    monkeypatch.setattr(cli, "_dispatch", lambda cfg, device: seen.append(
        (cfg.mode, _build.BUILD_DIR)))
    cache = tmp_path / "kernels" / "cache"
    cli.main(["--mode", "gen-labels", "--compile_cache_dir", str(cache)],
             device="cpu")
    assert cache.is_dir()
    assert seen == [("gen-labels", cache.resolve())]
    assert native.BUILD_DIR == cache.resolve()
    assert _build.library_path("vote").parent == cache.resolve()
    assert native.library_path().parent == cache.resolve()


def test_distributed_on_one_process_is_a_logged_noop(monkeypatch, capsys):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert cli.maybe_init_distributed(cli.config_from_args(
        ["--distributed"])) is False
    assert "skipped" in capsys.readouterr().out
    assert cli.maybe_init_distributed(cli.config_from_args([])) is False
    monkeypatch.setenv("RCVPOSE_PALLAS_CONV", "on")
    assert cli.conv_kernel_route() is True
    monkeypatch.delenv("RCVPOSE_PALLAS_CONV")
    assert cli.conv_kernel_route() is False
