"""The port's hier-vs-exact agreement study
(``rcvpose_tpu_torch.scripts.hier_exact_agreement``) against the JAX
package's ``scripts/hier_exact_agreement.py``, on the CPU.

The scene generators give the JAX script's arrays bit for bit from the
same seed; ``run_suite`` at a small size (grid 64, the JAX voting tests'
grid, and a few hundred points) gives the same frame, overflow and
agreement counts, with centre statistics within 1e-2 mm (a frame's
tolerance on the watch list); the command line walks the JAX script's
configurations.
"""

import importlib.util
import json
import pathlib

import numpy as np
import pytest

from rcvpose_tpu_torch.scripts import hier_exact_agreement as port

REPO = pathlib.Path(__file__).resolve().parents[1]
STATS = ("center_dist_mm_mean", "center_dist_mm_p95", "center_dist_mm_max",
         "kpt_err_mm_exact_mean", "kpt_err_mm_hier_mean")
CENTER_ATOL_MM = 1e-2


@pytest.fixture
def one_thread():
    """One intra-op thread for the port's plain exact votes (the suite's
    other workers share the cores); the counts are integer sums, the same
    on any number of threads."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_hier_exact_agreement", REPO / "scripts" /
        "hier_exact_agreement.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("scene", ["single", "cluttered", "maskbleed"])
def test_scene_generators_are_bit_equal(jax_script, scene):
    gens = {"single": "synth_frame", "cluttered": "synth_cluttered_frame",
            "maskbleed": "synth_maskbleed_frame"}
    rng_j, rng_p = np.random.default_rng(11), np.random.default_rng(11)
    for i in range(3):
        kw = {"n_points": 500}
        if scene == "single":
            kw["noise_dm"] = 0.05 * (i % 2)
        want = getattr(jax_script, gens[scene])(rng_j, **kw)
        got = getattr(port, gens[scene])(rng_p, **kw)
        for w, g in zip(want, got):
            w = np.asarray(w)
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
    # the port draws frames through scene_frame in run_suite's order
    rng_j, rng_p = np.random.default_rng(12), np.random.default_rng(12)
    for i in range(2):
        noise = 0.0 if i % 2 == 0 else 0.05
        want = (jax_script.synth_frame(rng_j, n_points=64, noise_dm=noise)
                if scene == "single" else
                getattr(jax_script, gens[scene])(rng_j, n_points=64))
        got = port.scene_frame(rng_p, scene, i, 64)
        np.testing.assert_array_equal(got[0], np.asarray(want[0]))
        np.testing.assert_array_equal(got[3], want[3])


@pytest.mark.parametrize("scene,frames", [("single", 3), ("cluttered", 2),
                                          ("maskbleed", 2)])
def test_run_suite_matches_jax(jax_script, one_thread, scene, frames):
    kw = dict(n_points=200, seed=1)
    want = jax_script.run_suite(frames, 64, scene, **kw)
    got = port.run_suite(frames, 64, scene, device="cpu", **kw)
    assert got.pop("vote_counts_launches") == 0     # plain versions here
    assert set(got) == set(want)
    for key in ("frames", "overflowed", "agree_within_1_voxel", "grid_l",
                "scene", "topk", "cpt_stride", "win", "note"):
        assert got.get(key) == want.get(key), key
    for key in STATS:
        if key in want:
            assert abs(got[key] - want[key]) <= CENTER_ATOL_MM, key
    if scene == "single":        # some frames compare their centres
        assert got["frames"] > 0


def test_hier_knobs_reach_run_suite(jax_script, one_thread):
    kw = dict(n_points=150, seed=2, topk=4, cpt_stride=1, win=12)
    want = jax_script.run_suite(2, 64, "single", **kw)
    got = port.run_suite(2, 64, "single", device="cpu", **kw)
    assert (got["topk"], got["cpt_stride"], got["win"]) == (4, 1, 12)
    for key in ("frames", "overflowed", "agree_within_1_voxel"):
        assert got[key] == want[key]
    for key in STATS:
        assert abs(got[key] - want[key]) <= CENTER_ATOL_MM, key


@pytest.mark.parametrize("argv,want", [
    ([], [("single", {})]),
    (["--scene", "both"], [("single", {}), ("cluttered", {})]),
    (["--scene", "maskbleed"], [("maskbleed", {})]),
    (["--sweep"], [(sc, {"topk": t, "cpt_stride": s})
                   for sc in ("single", "cluttered") for t in (2, 4, 8)
                   for s in (1, 4, 8)]),
    (["--sweep-win"], [(sc, {"topk": t, "win": w})
                       for sc in ("single", "cluttered") for t in (4, 8)
                       for w in (8, 12, 16)]),
])
def test_command_line_walks_the_jax_configurations(monkeypatch, argv, want):
    calls = []

    def fake(n_frames, grid_l, scene, device=None, **kw):
        calls.append((n_frames, grid_l, scene, kw, str(device)))
        return {"frames": n_frames, "scene": scene, **kw}

    monkeypatch.setattr(port, "run_suite", fake)
    lines = []
    recs = port.main(argv + ["--device", "cpu"], printer=lines.append)
    assert [(c[2], c[3]) for c in calls] == want
    assert all(c[:2] == (120, 128) and c[4] == "cpu" for c in calls)
    assert [json.loads(x) for x in lines] == recs
    assert all(r["device"] == "cpu" for r in recs)
    port.main(["7", "48", "--device", "cpu"], printer=lines.append)
    assert calls[-1][:3] == (7, 48, "single")


def test_raises_without_a_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.main(["1", "64"])
