"""The port's kernel-library cache (``utils.enable_compile_cache``,
``--compile_cache_dir``) and ``scripts/bench_compile_cache`` on the CPU.

The cache moves where ``ops._build`` builds and loads the CUDA libraries
and where ``native`` builds its readers; the native reader builds with
g++ into it here and loads from it; a library loaded from another
directory makes it raise; the bench's CPU smoke runs its two child
processes and prints its record.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from rcvpose_tpu_torch import native, utils
from rcvpose_tpu_torch.ops import _build

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def fresh_cache_state(monkeypatch):
    """The library directories and load records as a fresh process has
    them, restored afterwards."""
    for mod in (_build, native):
        monkeypatch.setattr(mod, "BUILD_DIR", mod.BUILD_DIR)
        monkeypatch.setattr(mod, "_loaded_from", {})


def test_the_native_reader_builds_and_loads_from_the_cache(
        tmp_path, fresh_cache_state):
    cache = tmp_path / "cache"
    assert utils.enable_compile_cache(str(cache)) == str(cache.resolve())
    lib = native.load_library()
    path = native.library_path()
    assert path.parent == cache.resolve() and path.is_file()
    assert lib.read_dpt is not None
    assert [p.name for p in cache.iterdir()] == [path.name]
    assert native._loaded_from == {"rcvpose_io": cache.resolve()}
    # the same directory again is fine; another raises
    utils.enable_compile_cache(str(cache))
    with pytest.raises(RuntimeError, match="rcvpose_io"):
        utils.enable_compile_cache(str(tmp_path / "other"))
    assert native.BUILD_DIR == cache.resolve()


@pytest.mark.parametrize("module,name", [(_build, "vote"),
                                         (_build, "other/vote_old"),
                                         (native, "zstd")])
def test_enable_raises_once_a_library_is_loaded_from_elsewhere(
        tmp_path, fresh_cache_state, module, name):
    module._loaded_from[name] = (tmp_path / "elsewhere").resolve()
    before = (_build.BUILD_DIR, native.BUILD_DIR)
    with pytest.raises(RuntimeError, match=name):
        utils.enable_compile_cache(str(tmp_path / "cache"))
    assert (_build.BUILD_DIR, native.BUILD_DIR) == before
    assert not (tmp_path / "cache").exists()
    utils.enable_compile_cache(str(tmp_path / "elsewhere"))
    assert _build.BUILD_DIR == (tmp_path / "elsewhere").resolve()


def test_build_dir_moves_with_the_cache(tmp_path, fresh_cache_state):
    default = _build.library_path("heads")
    utils.enable_compile_cache(str(tmp_path))
    moved = _build.library_path("heads")
    assert moved.name == default.name and moved.parent == tmp_path.resolve()


def test_bench_compile_cache_cpu_smoke_prints_its_record():
    # one intra-op thread in the children: the suite's other workers
    # share the cores
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    out = subprocess.run(
        [sys.executable, "-m", "rcvpose_tpu_torch.scripts.bench_compile_cache",
         "--small", "--device", "cpu"], cwd=REPO, capture_output=True,
        text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["metric"] == "compile_cache_warm_libs_s"
    assert rec["device"] == "cpu" and rec["cache_entries"] == []
    for run in (rec["cold"], rec["warm"]):
        assert run["built"] == [] and run["backend"] == "cpu"
        assert run["first_estimate_ms"] > 0 and run["second_estimate_ms"] > 0
        assert run["vote_counts_launches"] == 0
    assert rec["value"] == round(rec["warm"]["libs_s"], 3)


def test_bench_compile_cache_raises_without_a_card(monkeypatch):
    import torch

    from rcvpose_tpu_torch.scripts import bench_compile_cache

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_compile_cache.main([])
