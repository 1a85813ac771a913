"""The port's benchmark (``rcvpose_tpu_torch.bench``) against the JAX
package's ``bench.py``, on the CPU.

The record has ``bench.py``'s keys, minus ``vs_baseline`` and ``note`` and
plus ``device``, ``runs_ms`` and ``device_ms``, read from both sources
with ``ast`` so that a drift on either side fails; the pair-evaluation
counts are ``bench.py``'s formula over the JAX package's hier constants;
the inputs are ``bench.py``'s draws; the net, vote and fit stage scalars
equal the JAX package's (``bench.py``'s lambdas) on the same weights,
carried by ``checkpoint.from_flax_variables``, within f32 net 1e-4
relative, keypoint-center 1e-2 mm and Horn 1e-5; the CPU run prints one
parseable last line of finite positive times, and the entry points raise
without a card unless the CPU is named. ``vote_grid_oracle`` (the dense
L^3 oracle) equals the JAX package's at grid 16.
"""

import ast
import dataclasses
import json
import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rcvpose_tpu import eval as jax_eval
from rcvpose_tpu import fit as jax_fit
from rcvpose_tpu import train as jax_train
from rcvpose_tpu.config import Config as JaxConfig
from rcvpose_tpu.ops import voting as jax_voting
from rcvpose_tpu_torch import bench, ops
from rcvpose_tpu_torch import train as port_train
from rcvpose_tpu_torch.checkpoint import from_flax_variables

REPO = pathlib.Path(__file__).resolve().parent.parent
DROPPED = {"vs_baseline", "note"}
ADDED = {"device", "runs_ms", "device_ms"}


@pytest.fixture
def one_thread():
    """One intra-op thread for a test held against the port alone (the
    suite's other workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def record_keys(path):
    """Keys of the ``record`` dict of ``path``: its ``record = {...}``
    literal and every ``record["..."] = ...`` assignment."""
    keys = set()
    for node in ast.walk(ast.parse(pathlib.Path(path).read_text())):
        if not isinstance(node, ast.Assign):
            continue
        for target in node.targets:
            if (isinstance(target, ast.Name) and target.id == "record"
                    and isinstance(node.value, ast.Dict)):
                keys |= {k.value for k in node.value.keys}
            if (isinstance(target, ast.Subscript)
                    and isinstance(target.value, ast.Name)
                    and target.value.id == "record"):
                keys.add(target.slice.value)
    return keys


def test_record_keys_are_bench_pys():
    jax_keys = record_keys(REPO / "bench.py")
    port_keys = record_keys(REPO / "rcvpose_tpu_torch" / "bench.py")
    assert {"metric", "value", "fit_ms", "exact_mvotes_per_sec"} <= jax_keys
    assert port_keys == (jax_keys - DROPPED) | ADDED


@pytest.mark.parametrize("grid_l,n_points", [(128, 8192), (64, 1024),
                                             (192, 2048)])
def test_pair_evals_are_bench_pys_formula(grid_l, n_points):
    v = jax_voting
    hier = n_points * ((grid_l // v._COARSE) ** 3 // v._CPT_STRIDE
                       + v._TOPK * v._WIN ** 3)
    assert bench.pair_evals(grid_l, n_points) == (hier,
                                                  n_points * grid_l ** 3)


def test_config_and_inputs_are_bench_pys():
    cfg, hw, bsz = bench.bench_config("cpu")
    assert (cfg.compute_dtype, cfg.vote_grid_l, cfg.max_points,
            cfg.vote_mode, hw, bsz) == ("float32", 64, 1024, "hier",
                                        (96, 128), 2)
    cfg, hw, bsz = bench.bench_config("cuda", small=True)
    assert (cfg.compute_dtype, cfg.vote_grid_l, cfg.max_points, hw, bsz,
            cfg.model_width, cfg.model_blocks) == (
                "bfloat16", jax_voting.suggest_grid_l(0.102, 2.0), 8192,
                (480, 640), 4, 0.125, "1,1,1,1")
    # bench.py:170-178's draws
    h, w = 96, 128
    rng = np.random.default_rng(0)
    image = np.asarray(jnp.asarray(rng.normal(size=(h, w, 3)), jnp.float32))
    depth = np.zeros((h, w), np.float32)
    ys, xs = np.mgrid[h // 3:2 * h // 3, w // 3:2 * w // 3]
    depth[ys, xs] = rng.uniform(600, 900, size=ys.shape)
    gt_kpts = np.asarray(jnp.asarray(rng.normal(size=(3, 3)) * 100,
                                     jnp.float32))
    got = bench.bench_inputs(h, w, "cpu")
    for a, b in zip(got, (image, depth, np.array([2.0, 2.2, 2.4]),
                          gt_kpts)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b, np.float32))


@pytest.fixture(scope="module")
def small_nets():
    """The small net in f32 on both sides from one Flax variable tree:
    ``init``'s shapes (traced, not run) filled from a seed, conv kernels
    at variance 1 / fan-in, BN statistics and affine terms near 1 and 0."""
    kw = dict(compute_dtype="float32", model_blocks="1,1,1,1",
              model_width=0.125)
    jcfg = JaxConfig(**kw)
    model = jax_train.build_model(jcfg)
    shapes = jax.eval_shape(lambda key: model.init(
        key, jnp.zeros((1, 64, 64, 3), jnp.float32), False),
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return rng.normal(size=leaf.shape) / math.sqrt(fan_in)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, size=leaf.shape)
        return rng.normal(size=leaf.shape) * 0.1

    variables = jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.asarray(fill(p, x), jnp.float32), shapes)
    cfg, _, _ = bench.bench_config("cpu", small=True)
    net = port_train.build_model(cfg)
    net.load_state_dict(from_flax_variables(
        jax.tree.map(np.asarray, variables)))
    return model, variables, net.eval()


def test_net_stage_scalar_matches_jax(small_nets):
    model, variables, net = small_nets
    image, _, _, _ = bench.bench_inputs(96, 128, "cpu")
    want = float(jax.jit(lambda v, x: model.apply(v, x, False)[1].astype(
        jnp.float32).mean())(variables, jnp.asarray(image.numpy())[None]))
    with torch.no_grad():
        got = float(bench.net_scalar(net, image[None]))
    assert abs(got - want) <= 1e-4 * abs(want)


def _vote_maps():
    """A depth patch and the radial map (dm) of a keypoint 8 cm off its
    center, with every depth pixel in the mask."""
    _, depth, _, _ = bench.bench_inputs(96, 128, "cpu")
    d = depth.numpy()
    k = np.asarray(jax_eval.geometry.LINEMOD_K, np.float32)
    v, u = np.mgrid[0:96, 0:128].astype(np.float32)
    xyz = np.stack([(u - k[0, 2]) * d / k[0, 0],
                    (v - k[1, 2]) * d / k[1, 1], d], -1) / 1000.0
    kpt = np.array([0.0, 0.0, 0.75], np.float32) + xyz[48, 64] * [1, 1, 0]
    radial = np.where(d > 0, np.linalg.norm(xyz - kpt, axis=-1) * 10.0,
                      0.0).astype(np.float32)
    sem = (d > 0).astype(np.float32)
    return sem, d, radial, k


def test_vote_stage_scalar_matches_jax():
    sem, d, radial, k = _vote_maps()
    want = float(jax_eval.keypoint_from_maps(
        jnp.asarray(sem), jnp.asarray(radial), jnp.asarray(d),
        jnp.asarray(k), jnp.float32(2.0), jnp.float32(0.8), n_points=1024,
        grid_l=64, mode="hier")[0].astype(jnp.float32).mean())
    got = float(bench.vote_scalar(
        torch.tensor(sem), torch.tensor(d), torch.tensor(radial),
        torch.tensor(k), "hier", 1024, 64))
    assert math.isfinite(want) and abs(got - want) <= 1e-2


def test_fit_stage_scalar_matches_jax():
    _, _, _, gt = bench.bench_inputs(96, 128, "cpu")
    g = gt.numpy()
    rot = np.array([[0.8, -0.6, 0.0], [0.6, 0.8, 0.0], [0.0, 0.0, 1.0]],
                   np.float32)
    for est in (g + 1.0, g @ rot.T + 5.0):
        want = float(jax_fit.horn_fit(jnp.asarray(g), jnp.asarray(est))
                     .astype(jnp.float32).mean())
        got = float(bench.fit_scalar(gt, torch.tensor(est)))
        assert abs(got - want) <= 1e-5 * max(1.0, abs(want))


@pytest.mark.usefixtures("one_thread")
def test_cpu_run_prints_one_record(capsys, monkeypatch):
    """The whole run on the CPU at a quarter of the CPU branch's grid and
    points (the plain vote on one thread dominates at the CPU branch's
    own), one call a timed run."""
    config = bench.bench_config

    def smaller(device, small=False):
        cfg, hw, bsz = config(device, small)
        return dataclasses.replace(cfg, vote_grid_l=32,
                                   max_points=256), hw, bsz

    monkeypatch.setattr(bench, "bench_config", smaller)
    out = bench.main(["--small"], device="cpu", reps_scale=0.01)
    lines = capsys.readouterr().out.strip().splitlines()
    record = json.loads(lines[-1])
    assert record == json.loads(json.dumps(out))
    assert set(record) == (record_keys(REPO / "rcvpose_tpu_torch"
                                       / "bench.py")
                           - {"exact_vote_ms_per_kpt",
                              "exact_mvotes_per_sec"})
    assert record["backend"] == "cpu" and record["device"] == "cpu"
    assert record["device_ms"] is None
    times = [record[k] for k in ("value", "batched_frames_per_sec",
                                 "fused_multihead_frames_per_sec",
                                 "fused_frame_ms",
                                 "fused_batched_frames_per_sec", "net_ms",
                                 "vote_ms_per_kpt", "fit_ms", "frame_ms",
                                 "mvotes_per_sec",
                                 "mvotes_ref_equiv_per_sec")]
    times += [t for runs in record["runs_ms"].values() for t in runs]
    assert all(math.isfinite(t) and t > 0 for t in times)
    assert all(len(runs) == bench.RUNS for runs in record["runs_ms"].values())
    assert (record["vote_grid_l"], record["vote_points"],
            record["batch_size"]) == (32, 256, 2)
    assert record["mvotes_per_sec"] == pytest.approx(
        bench.pair_evals(32, 256)[0] / record["vote_ms_per_kpt"] / 1e3,
        rel=1e-2)


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--small"])


def test_vote_grid_oracle_matches_jax():
    rng = np.random.default_rng(3)
    n, grid_l = 40, 16
    points = rng.uniform(0, grid_l, size=(n, 3)).astype(np.float32)
    radii = np.round(rng.uniform(0, 9, size=n)).astype(np.float32)
    mask = rng.uniform(size=n) > 0.2
    want = np.asarray(jax_voting.vote_grid_oracle(
        jnp.asarray(points), jnp.asarray(radii), jnp.asarray(mask), grid_l))
    got = ops.vote_grid_oracle(torch.tensor(points), torch.tensor(radii),
                               torch.tensor(mask), grid_l).numpy()
    assert want.sum() > 0
    np.testing.assert_array_equal(got, want)


def test_ops_exports_the_jax_list():
    import rcvpose_tpu.ops as jax_ops

    names = ["VOTE_BAND", "AccumulatorResult", "accumulate_3d",
             "vote_counts_reference", "vote_grid_oracle"]
    for name in names:
        assert hasattr(jax_ops, name) and hasattr(ops, name), name
    assert ops.VOTE_BAND == jax_voting.VOTE_BAND


def test_new_modules_import_with_jax_and_the_jax_package_blocked():
    """The bench, the measuring scripts, the checkpointer, the evaluator
    and the CLI import with ``jax``, ``rcvpose_tpu``, the root ``bench.py``
    and the root ``scripts/`` blocked in ``sys.modules``."""
    import subprocess
    import sys

    code = (
        "import importlib, sys\n"
        "for name in ('jax', 'rcvpose_tpu', 'bench', 'scripts'):\n"
        "    sys.modules[name] = None\n"
        "for name in ('bench', 'checkpoint', 'eval', 'cli',\n"
        "             'scripts.bench_train', 'scripts.bench_train_loop',\n"
        "             'scripts.bench_serving_latency',\n"
        "             'scripts.bench_eval_prefetch'):\n"
        "    importlib.import_module('rcvpose_tpu_torch.' + name)\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", (
        proc.stdout + proc.stderr)
