"""The harness on the CPU: cells found by name and new files picked up
without an edit, seeded inputs, and the shape of the result line."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from perfbench.harness import bench, seeds, traffic, weights
from perfbench.tests import small

CONTRACT_KEYS = {"correct", "attempted", "failed", "metrics", "device"}


@pytest.fixture(autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def test_cells_and_metrics_found_by_name():
    bench_json = json.loads((bench.ROOT / "BENCHMARK.json").read_text())
    for w in bench_json["workloads"]:
        cell = bench.load_cell(w["name"])
        assert cell.chips == w["chips"]
        assert cell.config["name"] == w["config"]
        assert cell.end_to_end and cell.per_layer
        assert "setup_s" in {m["name"] for m in cell.end_to_end}
        for m in cell.per_layer + cell.end_to_end:
            assert (bench.ROOT / "perfbench" / "metrics"
                    / f"{m['name']}.py").exists()
    per_layer = {c: {m["name"] for m in bench.load_cell(c).per_layer}
                 for c in ("serve-3net-lm", "refine-3net-lm")}
    assert per_layer["refine-3net-lm"] - per_layer["serve-3net-lm"] == {
        "icp_device_ms"}
    with pytest.raises(SystemExit):
        bench.load_cell("no-such-cell")


def test_new_files_are_picked_up_without_an_edit(tmp_path):
    """A new configuration, traffic mix, cell, driver and metric are new
    files plus entries in BENCHMARK.json."""
    shutil.copytree(bench.ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    b = json.loads((bench.ROOT / "BENCHMARK.json").read_text())
    pb = tmp_path / "perfbench"
    cfg = json.loads((pb / "configs" / "rcvpose-3net-lm.json").read_text())
    cfg["name"] = "new-config"
    (pb / "configs" / "new-config.json").write_text(json.dumps(cfg))
    tr = json.loads((pb / "traffic" / "lm-one-object.json").read_text())
    (pb / "traffic" / "new-mix.json").write_text(json.dumps(tr))
    (pb / "workloads" / "new-cell.json").write_text(json.dumps(
        {"driver": "count_only", "check": {"limits": {"seen": 1}}}))
    (pb / "drivers" / "count_only.py").write_text(
        "def run(run):\n"
        "    run.setup_done()\n"
        "    run.window = {'seconds': 1.0, 'frames': 7}\n"
        "    run.attempted = 7\n"
        "    run.checks = [('seen', 1, run.cell.workload['check']"
        "['limits']['seen'])]\n")
    (pb / "metrics" / "new_metric.py").write_text(
        "def read(run):\n    return run.window['frames'] * 2.0\n")
    b["configs"].append({"name": "new-config", "source": "x",
                         "file": "perfbench/configs/new-config.json",
                         "reduced": [], "why": "x"})
    b["workloads"].append({"name": "new-cell", "config": "new-config",
                           "traffic": "new-mix", "chips": 1, "why": "x"})
    b["end_to_end"].append({"name": "new_metric", "unit": "x",
                            "better": "higher", "bound": 0.1,
                            "source": "host_clock",
                            "workloads": ["new-cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    cell = bench.load_cell("new-cell", tmp_path)
    r = bench.Run(cell=cell, seed=1, seconds=1.0, trace=False,
                  device=torch.device("cpu"), t0=0.0)
    out, _ = bench.result(bench.drive(r), "cpu")
    assert out["metrics"]["new_metric"]["value"] == 14.0
    assert "setup_s" in out["metrics"] and out["correct"]


def test_same_seed_same_inputs_other_seed_other_inputs():
    params = {"pool": 3, "area_px": [150, 400], "depth_mm": [600, 1200],
              "aspect": [0.6, 1.0], "fit_hw": [40, 60]}
    k = np.array([[572.4114, 0, 48.0], [0, 573.57043, 32.0], [0, 0, 1.0]])
    seed = 2 ** 40 + 3
    a = traffic.frames(params, seed, 64, 96, k)
    b = traffic.frames(params, seed, 64, 96, k)
    c = traffic.frames(params, seed + 1, 64, 96, k)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert not np.array_equal(a[0], c[0])
    assert not np.array_equal(a[1], c[1])
    # every seed draws the same set of areas, in its own order
    assert sorted(a[2]) == pytest.approx(sorted(c[2]), rel=0.05)
    assert (a[1] > 0).sum(axis=(1, 2)).tolist() == a[2].tolist()
    head = {"seg_bias": 5.0, "seg_std": 1.0, "radial_bias": 1.0,
            "radial_std": 0.15, "feature_rms": 3.0}
    w1 = weights.make_net(seed, 0, 1, head, torch.float32, "cpu",
                          (1, 1, 1, 1), 0.125)
    w2 = weights.make_net(seed, 0, 1, head, torch.float32, "cpu",
                          (1, 1, 1, 1), 0.125)
    w3 = weights.make_net(seed, 1, 1, head, torch.float32, "cpu",
                          (1, 1, 1, 1), 0.125)
    assert all(torch.equal(w1[n], w2[n]) for n in w1)
    assert not torch.equal(w1["conv1.weight"], w3["conv1.weight"])
    assert seeds.derive(2 ** 70, "x") != seeds.derive(2 ** 70 + 1, "x")


def test_init_scheme_moments():
    head = {"seg_bias": 5.0, "seg_std": 1.0, "radial_bias": 1.0,
            "radial_std": 0.15, "feature_rms": 3.0}
    w = weights.make_net(7, 0, 1, head, torch.float32, "cpu",
                         (1, 1, 1, 1), 0.125)
    x = w["block1up.conv2.weight"]
    fan_in = x[0].numel()
    assert x.std().item() == pytest.approx(fan_in ** -0.5, rel=0.1)
    assert x.abs().max().item() <= 2 * fan_in ** -0.5 / weights.TRUNC_STD
    assert w["conv8.bias"].tolist() == [5.0, 1.0]


@pytest.mark.parametrize("name,trace", [
    ("serve-3net-lm", False), ("serve-3net-lm", True),
    ("refine-3net-lm", False), ("refine-3net-lm", True)])
def test_result_line_has_the_contract_keys(name, trace):
    out, lines, _ = small.run(name, trace=trace)
    keys = set(out)
    assert CONTRACT_KEYS <= keys
    assert keys - CONTRACT_KEYS <= {"breakdown", "checks"}
    assert list(out)[-1] == "checks"
    assert out["correct"] is True
    assert lines[-1].startswith("check ")
    if trace:
        assert {"busy_s", "window_s"} <= set(out["device"])
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert "setup_s" in out["metrics"]
    json.dumps(out)


def test_run_without_a_card_prints_no_result(tmp_path):
    """Without CUDA the command exits 2 with nothing on standard output;
    so does a directory that holds only BENCHMARK.json and perfbench/."""
    shutil.copytree(bench.ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(bench.ROOT / "BENCHMARK.json", tmp_path)
    for cwd in (bench.ROOT, tmp_path):
        p = subprocess.run(
            [sys.executable, "perfbench/run.py", "--workload",
             "serve-3net-lm", "--seed", "1", "--seconds", "1", "--trace",
             "0"], cwd=cwd, capture_output=True, text=True, timeout=300)
        if torch.cuda.is_available():
            pytest.skip("a CUDA card is present")
        assert p.returncode == 2 and p.stdout == ""
