"""The port's orbax reader against the real implementations, on the CPU.

Layer by layer: the port's zstd decoder (``native/zstd.cpp``) against
``zstandard``, its OCDBT reader (``ocdbt.py``) and zarr v2 / orbax tree
reader (``orbax_read.py``) against ``tensorstore`` and orbax, then
``checkpoint.orbax_variables`` on the JAX ``Checkpointer``'s own output,
the evaluator and the CLI's ``export-torch`` on orbax trees, and the
fixtures ``chip_smoke.py`` carries and writes. ``zstandard``,
``tensorstore`` and orbax are imported here only: the port reads without
them. Tiny nets (blocks (1,1,1,1), width 0.125) keep the file quick.
"""

import base64
import io
import os
import tarfile
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import tensorstore as ts
import torch
import zstandard
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import chip_smoke
from rcvpose_tpu import checkpoint as jax_checkpoint
from rcvpose_tpu import cli as jax_cli
from rcvpose_tpu import train as jax_train
from rcvpose_tpu.checkpoint import Checkpointer as JaxCheckpointer
from rcvpose_tpu.config import Config as JaxConfig
from rcvpose_tpu_torch import checkpoint as port_checkpoint
from rcvpose_tpu_torch import cli as port_cli
from rcvpose_tpu_torch import eval as port_eval
from rcvpose_tpu_torch import orbax_read
from rcvpose_tpu_torch import serve as port_serve
from rcvpose_tpu_torch import train as port_train
from rcvpose_tpu_torch.config import Config
from rcvpose_tpu_torch.native import zstd
from rcvpose_tpu_torch.ocdbt import OcdbtStore
from tests.test_eval_lm_format import make_lm_eval_tree

NET_KW = dict(model_blocks="1,1,1,1", model_width=0.125,
              compute_dtype="float32")
EVAL_KW = dict(vote_grid_l=96, max_points=2048, vote_mode="hier",
               icp_iters=5, eval_data_parallel=False, image_height=128,
               image_width=160)


# ---------------------------------------------------------------------------
# zstd
# ---------------------------------------------------------------------------

def _payloads():
    rng = np.random.default_rng(0)
    text = b"".join(b"rcvpose %d keypoint %d; " % (i, i % 7)
                    for i in range(12000))
    # a random block, then copies of its pieces joined by one literal byte:
    # level 19 codes those literals as RLE and repeats its tables
    base = rng.bytes(1 << 17)
    starts = rng.integers(0, (1 << 17) - 64, 3000)
    copies = b"".join([base] + [base[s:s + 20 + s % 40] + b"x"
                                for s in map(int, starts)])
    return {
        "empty": b"",
        "one byte repeated": b"\x2a" * 200_000,
        "random bytes": rng.bytes(150_000),
        "long matches": text,
        "copies and one literal": copies,
        "f32 random walk": (np.cumsum(rng.integers(-2, 3, 90_000)) / 8.0
                            ).astype(np.float32).tobytes(),
        "f32 weights": (rng.normal(size=60_000) * 0.02).astype(
            np.float32).tobytes(),
    }


PAYLOADS = _payloads()
FRAMES = [(name, level, checksum, size)
          for name in PAYLOADS for level in (1, 3, 19)
          for checksum in (False, True) for size in (False, True)]


@pytest.mark.parametrize(
    "name,level,checksum,size", FRAMES,
    ids=[f"{n.replace(' ', '-')}-l{lv}-{'xxh' if c else 'nochk'}-"
         f"{'fcs' if s else 'nofcs'}" for n, lv, c, s in FRAMES])
def test_zstd_matches_zstandard(name, level, checksum, size):
    data = PAYLOADS[name]
    frame = zstandard.ZstdCompressor(
        level=level, write_checksum=checksum,
        write_content_size=size).compress(data)
    assert zstd.decompress(frame, len(data)) == data
    assert zstd.decompress(frame) == data
    with pytest.raises(ValueError):  # a frame decodes to its length only
        zstd.decompress(frame, len(data) + 1)


def test_zstd_concatenated_skippable_and_modes():
    """Concatenated and skippable frames; over the level-1/3/19 frames of
    every payload the decoder meets every block, literal and sequence-table
    mode it implements."""
    a, b = PAYLOADS["long matches"], PAYLOADS["f32 random walk"]
    skip = (0x184D2A53).to_bytes(4, "little") + (5).to_bytes(4, "little")
    frames = (zstandard.ZstdCompressor(level=3).compress(a) + skip
              + b"abcde" + zstandard.ZstdCompressor(level=1).compress(b))
    zstd.reset_stats()
    assert zstd.decompress(frames, len(a) + len(b)) == a + b
    assert zstd.STATS["skippable_frames"] == 1
    assert zstd.STATS["frames"] == 2
    zstd.reset_stats()
    for name, data in PAYLOADS.items():
        for level in (1, 3, 19):
            for write_size in (False, True):
                frame = zstandard.ZstdCompressor(
                    level=level, write_content_size=write_size
                ).compress(data)
                assert zstd.decompress(frame, len(data)) == data
    seen = {k for k, v in zstd.STATS.items() if v}
    assert seen >= {"raw_blocks", "rle_blocks", "compressed_blocks",
                    "raw_literals", "rle_literals", "huffman_1_stream",
                    "huffman_4_streams", "treeless_literals",
                    "predefined_tables", "rle_tables", "fse_tables",
                    "repeat_tables"}, seen
    with pytest.raises(ValueError, match="no zstd frame"):
        zstd.decompress(b"", 0)
    dict_frame = bytearray(zstandard.ZstdCompressor(level=1).compress(b"x"))
    dict_frame[4] |= 1  # a 1-byte dictionary id
    dict_frame[5:5] = b"\x07"
    with pytest.raises(ValueError, match="dictionary"):
        zstd.decompress(bytes(dict_frame))


def test_crc32c_matches_ocdbt_trailers(tmp_path):
    """CRC-32C's check value, and every OCDBT file's trailer that
    tensorstore wrote."""
    assert zstd.crc32c(b"123456789") == 0xE3069283
    _write_tensorstore_kv(tmp_path, 5)
    files = [tmp_path / "manifest.ocdbt", *(tmp_path / "d").iterdir()]
    for f in files:
        data = f.read_bytes()
        assert zstd.crc32c(data[:-4]) == int.from_bytes(data[-4:], "little")


CORRUPT = [(data, zstandard.ZstdCompressor(
    level=level, write_checksum=True).compress(data))
    for data, level in ((PAYLOADS["long matches"][:40_000], 3),
                        (PAYLOADS["f32 random walk"][:40_000], 1),
                        (PAYLOADS["random bytes"][:40_000], 1))]


@settings(max_examples=150, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(which=st.integers(0, len(CORRUPT) - 1),
       flips=st.lists(st.tuples(st.integers(0, 1 << 30), st.integers(0, 7)),
                      max_size=4),
       cut=st.integers(0, 1 << 30), truncate=st.booleans())
def test_zstd_corrupt_frames_raise_or_decode_right(which, flips, cut,
                                                   truncate):
    """Flipped bits and truncations of valid frames (with a content
    checksum) raise ValueError or decode to the right bytes; the worker
    survives every one."""
    data, frame = CORRUPT[which]
    frame = bytearray(frame)
    for pos, bit in flips:
        frame[pos % len(frame)] ^= 1 << bit
    if truncate:
        frame = frame[:cut % len(frame)]
    try:
        got = zstd.decompress(bytes(frame), len(data))
    except ValueError:
        return
    assert got == data


# ---------------------------------------------------------------------------
# OCDBT and zarr v2 against tensorstore and orbax
# ---------------------------------------------------------------------------

def _write_tensorstore_kv(path, n, **config):
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{path}/",
                          "config": config}).result()
    with ts.Transaction() as txn:
        for i in range(n):
            kv.with_transaction(txn).write(
                b"prefix/common/key%03d" % i, bytes([i % 251]) * (i % 50)
            ).result()
    return kv


def _same_store(path):
    kv = ts.KvStore.open({"driver": "ocdbt",
                          "base": f"file://{path}/"}).result()
    keys = sorted(bytes(k) for k in kv.list().result())
    store = OcdbtStore(path)
    assert store.list() == keys
    for key in keys:
        assert store.read(key) == bytes(kv.read(key).result().value), key
    assert store.read(b"absent") is None
    if keys:
        prefix = keys[len(keys) // 2][:16]
        assert store.list(prefix) == [k for k in keys
                                      if k.startswith(prefix)]
    return keys


@pytest.mark.parametrize("config", [
    {}, {"max_decoded_node_bytes": 300, "max_inline_value_bytes": 16,
         "compression": {"id": "zstd", "level": 5}},
    {"compression": {"id": "zstd"}, "max_inline_value_bytes": 4}],
    ids=["defaults", "interior-nodes", "all-indirect"])
def test_ocdbt_matches_tensorstore(tmp_path, config):
    _write_tensorstore_kv(tmp_path, 60, **config)
    assert len(_same_store(tmp_path)) == 60


def _orbax_tree():
    """A tree of every dtype the reader takes, a tuple and a 0-d array."""
    rng = np.random.default_rng(1)
    return {
        "f32": rng.normal(size=(3, 40, 50)).astype(np.float32),
        "nested": {"f64": rng.normal(size=(7,)),
                   "i32": rng.integers(-9, 9, (5, 2)).astype(np.int32),
                   "i64": rng.integers(0, 1 << 40, (4,)),
                   "u8": rng.integers(0, 256, (6,), dtype=np.uint8),
                   "b1": rng.random((3, 3)) < 0.5},
        "bf16": jnp.asarray(rng.normal(size=(4, 6)), jnp.bfloat16),
        "zero_d": np.asarray(42, np.int64),
        "pair": (np.arange(5, dtype=np.float32), np.asarray(2.5)),
    }


def _jax_like(got):
    """A reader tree with bf16 tensors as jnp arrays, for tree comparison."""
    return jax.tree_util.tree_map(
        lambda v: (jnp.asarray(v.float().numpy(), jnp.bfloat16)
                   if isinstance(v, torch.Tensor) else v), got)


def _assert_same(got, want):
    flat_g = jax.tree_util.tree_leaves_with_path(_jax_like(got))
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    assert [jax.tree_util.keystr(p) for p, _ in flat_g] == \
        [jax.tree_util.keystr(p) for p, _ in flat_w]
    for (path, g), (_, w) in zip(flat_g, flat_w):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, path
        assert g.tobytes() == w.tobytes(), path


@pytest.mark.parametrize("chunked", [False, True],
                         ids=["one-chunk", "several-chunks"])
def test_orbax_tree_matches_orbax_and_tensorstore(tmp_path, chunked):
    tree = _orbax_tree()
    path = str(tmp_path / "ckpt")
    saver = ocp.StandardCheckpointer()
    if chunked:
        args = jax.tree_util.tree_map(
            lambda _: ocp.SaveArgs(chunk_byte_size=1024), tree)
        saver.save(path, tree, save_args=args)
    else:
        saver.save(path, tree)
    saver.wait_until_finished()
    _same_store(path)
    got = orbax_read.read_tree(path)
    assert isinstance(got["pair"], tuple)
    assert isinstance(got["bf16"], torch.Tensor) and \
        got["bf16"].dtype == torch.bfloat16
    _assert_same(got, tree)
    _assert_same(got, ocp.StandardCheckpointer().restore(path))
    f32_keys = OcdbtStore(path).list(b"f32/")  # .zarray and its chunks
    assert (len(f32_keys) > 2) == chunked
    ck = orbax_read.OrbaxCheckpoint(path)
    part = ck.read_tree(("nested",))
    assert sorted(part) == ["nested"]
    with pytest.raises(KeyError, match="absent"):
        ck.read_tree(("absent",))


@pytest.mark.parametrize("fill", [1.5, None], ids=["fill", "no-fill"])
def test_missing_chunks_take_the_fill_value(tmp_path, fill):
    """Chunks tensorstore never wrote read as ``fill_value``; with none
    the reader refuses. Chunks 2x4 over a 4x6 array: edge chunks too."""
    store = {"driver": "ocdbt", "base": f"file://{tmp_path}/", "path": "a/"}
    arr = ts.open({"driver": "zarr", "kvstore": store, "create": True,
                   "metadata": {"shape": [4, 6], "chunks": [2, 4],
                                "dtype": "<f4", "fill_value": fill,
                                "compressor": {"id": "zstd"}}}).result()
    arr[0:2, 0:4] = np.arange(8, dtype=np.float32).reshape(2, 4)
    arr[2:4, 4:6] = -np.ones((2, 2), np.float32)
    (tmp_path / "_CHECKPOINT_METADATA").write_text("{}")
    (tmp_path / "_METADATA").write_text(
        '{"tree_metadata": {"(\'a\',)": {"key_metadata": [{"key": "a", '
        '"key_type": 2}]}}, "use_ocdbt": true, "use_zarr3": false}')
    if fill is None:
        with pytest.raises(ValueError, match="no fill_value"):
            orbax_read.read_tree(str(tmp_path))
        return
    got = orbax_read.read_tree(str(tmp_path))["a"]
    assert got.tobytes() == arr.read().result().tobytes()
    assert got[3, 0] == 1.5 and got[3, 5] == -1.0


def test_orbax_reader_refuses_other_layouts(tmp_path):
    tree = {"a": np.arange(4, dtype=np.float32)}
    for name, kw, refusal in (("zarr3", {"use_zarr3": True}, "zarr3"),
                              ("no_ocdbt", {"use_ocdbt": False}, "OCDBT")):
        handler = ocp.PyTreeCheckpointHandler(**kw)
        with ocp.Checkpointer(handler) as ckpt:
            ckpt.save(str(tmp_path / name),
                      args=ocp.args.PyTreeSave(tree))
        with pytest.raises(ValueError, match=refusal):
            orbax_read.read_tree(str(tmp_path / name))
    data = bytearray((tmp_path / "zarr3" / "manifest.ocdbt").read_bytes())
    data[0] ^= 0xFF
    (tmp_path / "bad").mkdir()
    (tmp_path / "bad" / "manifest.ocdbt").write_bytes(bytes(data))
    with pytest.raises(ValueError, match="magic"):
        OcdbtStore(str(tmp_path / "bad"))
    data[0] ^= 0xFF
    data[20] ^= 0x01  # a body byte: the CRC-32C trailer no longer matches
    (tmp_path / "bad" / "manifest.ocdbt").write_bytes(bytes(data))
    with pytest.raises(ValueError, match="CRC-32C"):
        OcdbtStore(str(tmp_path / "bad"))


# ---------------------------------------------------------------------------
# The JAX Checkpointer's own output, the evaluator and the CLI
# ---------------------------------------------------------------------------

def _train_steps(cfg):
    """``_train_and_save``'s one optimizer step on a synthetic batch
    (tests/test_eval_from_train.py), jitted: one XLA compile a layout
    instead of one a primitive."""
    init = jax.jit(lambda key: jax_train.create_state(
        cfg, key, steps_per_epoch=10, sample_shape=(1, 32, 32, 3)))
    step = jax.jit(jax_train.train_step)

    def run(path, seed):
        state = init(jax.random.PRNGKey(seed))
        rng = np.random.default_rng(seed)
        k = cfg.kpt_heads
        radial = np.zeros((2, 32, 32, k), np.float32)
        radial[:, 8:24, 8:24, :] = rng.uniform(1, 3, size=(2, 16, 16, k))
        sem = np.where(radial > 0, 1.0, -1.0).astype(np.float32)
        batch = {"image": rng.normal(size=(2, 32, 32, 3)).astype(np.float32),
                 "radial": radial.squeeze(-1) if k == 1 else radial,
                 "sem": sem.squeeze(-1) if k == 1 else sem}
        state, m = step(state, batch)
        JaxCheckpointer(path).save(state, epoch=0, iteration=1,
                                   best_val=float(m["loss"]), is_best=True)
        return state

    return run


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One JAX train step each, saved by the JAX Checkpointer: the 3-net
    layout (three nets) and the fused layout (one three-head net), with
    the states."""
    root = tmp_path_factory.mktemp("trained")
    states = {}
    for heads in (1, 3):
        run = _train_steps(JaxConfig(kpt_heads=heads, image_height=32,
                                     image_width=32, **NET_KW))
        names = ([f"ape_pt{i}" for i in range(1, 4)] if heads == 1
                 else ["ape"])
        states[heads] = {n: run(str(root / f"heads{heads}" / n), seed=i)
                         for i, n in enumerate(names, 1)}
    return root, states


@pytest.mark.parametrize("heads", [1, 3], ids=["3-net", "fused"])
def test_orbax_variables_equal_the_jax_state(trained, heads):
    root, states = trained
    for name, state in states[heads].items():
        path = root / f"heads{heads}" / name
        got = port_checkpoint.orbax_variables(str(path))
        _assert_same(got, {"params": state.params,
                           "batch_stats": state.batch_stats})
        model = port_train.build_model(Config(kpt_heads=heads, **NET_KW))
        port_checkpoint.load_model_weights(
            model, port_checkpoint.import_torch_checkpoint(str(path)))
        ref = port_train.build_model(Config(kpt_heads=heads, **NET_KW))
        port_checkpoint.load_model_weights(
            ref, port_checkpoint.from_flax_variables(jax.tree_util.tree_map(
                np.asarray, {"params": state.params,
                             "batch_stats": state.batch_stats})))
        x = torch.tensor(np.random.default_rng(3).normal(
            size=(1, 32, 32, 3)).astype(np.float32))
        with torch.no_grad():
            for a, b in zip(model.eval()(x), ref.eval()(x)):
                assert torch.equal(a, b)


def test_orbax_read_skips_opt_state(trained):
    root, _ = trained
    path = root / "heads1" / "ape_pt1" / "ckpt"
    zstd.reset_stats()
    ck = orbax_read.OrbaxCheckpoint(str(path))
    ck.read_tree(("params", "batch_stats"))
    params_frames = zstd.STATS["frames"]
    zstd.reset_stats()
    orbax_read.OrbaxCheckpoint(str(path)).read_tree()
    # the whole payload decodes mu and nu too: about three times the frames
    assert zstd.STATS["frames"] > 2 * params_frames
    assert ck.store.bytes_read < 0.75 * chip_smoke.dir_bytes(str(path))


@pytest.fixture
def one_thread():
    """One intra-op thread for a test that holds the port against itself:
    beside the suite's other workers torch's default (a thread a core)
    oversubscribes the cores (this evaluator test took 147 s there against
    5 s alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("heads", [1, 3], ids=["3-net", "fused"])
def test_evaluator_on_orbax_equals_pth_exports(trained, tmp_path, heads,
                                               monkeypatch):
    """The port's LM evaluator reading the JAX orbax tree gives the
    per-frame scores of its run on .pth.tar exports of the same weights;
    a relative --model_dir works."""
    root, states = trained
    tree = make_lm_eval_tree(tmp_path / "data",
                             np.random.default_rng(0), h=128, w=160)
    pth_dir = tmp_path / "pth"
    pth_dir.mkdir()
    for name, state in states[heads].items():
        variables = {"params": state.params,
                     "batch_stats": state.batch_stats}
        if heads == 1:
            jax_checkpoint.export_torch_checkpoint(
                variables, str(pth_dir / f"{name}.pth.tar"))
        else:
            (pth_dir / name).mkdir()
            jax_checkpoint.export_torch_checkpoint(
                variables, str(pth_dir / name / "model_best.pth.tar"))
    runs = {}
    monkeypatch.chdir(root)
    for route, model_dir in (("orbax", f"heads{heads}"),
                             ("pth", str(pth_dir))):
        cfg = Config(root_dataset=tree, model_dir=model_dir,
                     kpt_heads=heads, **NET_KW, **EVAL_KW)
        runs[route] = chip_smoke.recorded(
            port_eval, lambda c=cfg: port_eval.estimate_6d_pose_lm(
                c, class_names=["ape"], device="cpu",
                progress=lambda m: None)["ape"])
    assert runs["orbax"][1] == runs["pth"][1]
    assert len(runs["orbax"][1]) == 2
    for key in ("frames", "add_before_icp", "add_after_icp"):
        assert runs["orbax"][0][key] == runs["pth"][0][key]
    # --mode serve finds the same nets through eval._load_models
    served = [port_serve.build_lm_estimator(
        Config(root_dataset=tree, model_dir=model_dir, kpt_heads=heads,
               **NET_KW, **EVAL_KW), "ape", device="cpu").models
        for model_dir in (f"heads{heads}", str(pth_dir))]
    for a, b in zip(*served):
        for (k, v), w in zip(a.state_dict().items(),
                             b.state_dict().values()):
            assert torch.equal(v, w), k


def test_missing_checkpoint_errors_name_both_formats(tmp_path):
    cfg = Config(model_dir=str(tmp_path / "nothing"), **NET_KW)
    with pytest.raises(FileNotFoundError, match="orbax"):
        port_eval._load_models(cfg, "ape", torch.device("cpu"))
    cfg = Config(model_dir=str(tmp_path / "nothing"), kpt_heads=3, **NET_KW)
    with pytest.raises(FileNotFoundError, match="fused.*orbax"):
        port_eval._load_models(cfg, "ape", torch.device("cpu"))


def test_export_torch_matches_the_jax_cli(trained, tmp_path):
    root, _ = trained
    ckpts = str(root / "heads1" / "ape_pt2")
    flags = ["--model_blocks", "1,1,1,1", "--model_width", "0.125",
             "--compute_dtype", "float32"]
    jax_out, port_out = str(tmp_path / "jax.pth.tar"), str(
        tmp_path / "port.pth.tar")
    jax_cli.main(["--mode", "export-torch", "--model_dir", ckpts,
                  "--export_path", jax_out, *flags])
    port_cli.main(["--mode", "export-torch", "--model_dir", ckpts,
                   "--export_path", port_out])
    a = torch.load(jax_out, map_location="cpu", weights_only=False)
    b = torch.load(port_out, map_location="cpu", weights_only=True)
    assert {k: v for k, v in a.items() if k != "model_state_dict"} == \
        {k: v for k, v in b.items() if k != "model_state_dict"}
    assert list(a["model_state_dict"]) == list(b["model_state_dict"])
    for k, v in a["model_state_dict"].items():
        w = b["model_state_dict"][k]
        assert v.dtype == w.dtype and torch.equal(v, w), k


# ---------------------------------------------------------------------------
# The fixtures chip_smoke.py carries and writes
# ---------------------------------------------------------------------------

def write_chip_fixture(path):
    """The carried directory: ``chip_smoke.orbax_fixture_arrays()`` saved
    by orbax's StandardCheckpointer."""
    tree = chip_smoke.orbax_fixture_arrays()
    tree["scale"] = jnp.asarray(tree["scale"].float().numpy(), jnp.bfloat16)
    saver = ocp.StandardCheckpointer()
    saver.save(path, tree)
    saver.wait_until_finished()
    return tree


def pack_dir(path):
    """A directory as base64(zlib(tar)), as ``chip_smoke.ORBAX_DIR``."""
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w", format=tarfile.PAX_FORMAT) as t:
        for rel in sorted(os.path.relpath(os.path.join(r, f), path)
                          for r, _, fs in os.walk(path) for f in fs):
            info = t.gettarinfo(os.path.join(path, rel), arcname=rel)
            info.mtime, info.uid, info.gid = 0, 0, 0
            info.uname = info.gname = ""
            with open(os.path.join(path, rel), "rb") as f:
                t.addfile(info, f)
    return base64.b64encode(zlib.compress(buf.getvalue(), 9)).decode()


def test_carried_fixture_restores_with_orbax(tmp_path):
    chip_smoke.unpack_dir(chip_smoke.ORBAX_DIR, str(tmp_path))
    want = chip_smoke.orbax_fixture_arrays()
    restored = ocp.StandardCheckpointer().restore(str(tmp_path))
    restored["pair"] = tuple(restored["pair"])  # orbax restores a list
    restored["scale"] = torch.tensor(
        np.asarray(restored["scale"], np.float32), dtype=torch.bfloat16)
    chip_smoke.same_tree(jax.tree_util.tree_map(
        lambda v: v if isinstance(v, torch.Tensor) else np.asarray(v),
        restored, is_leaf=lambda v: isinstance(v, torch.Tensor)), want)
    zstd.reset_stats()
    chip_smoke.same_tree(orbax_read.read_tree(str(tmp_path)), want)
    assert zstd.STATS["compressed_blocks"] and zstd.STATS["fse_tables"]
    assert zstd.STATS["huffman_4_streams"] + zstd.STATS["huffman_1_stream"]


def test_chip_writer_output_restores_with_orbax_and_tensorstore(tmp_path):
    """The script's full-width writer, at a tiny width: its tree restores
    with orbax and lists with tensorstore to the arrays it was given, and
    the inverse bridge round-trips a port state dict."""
    model = port_train.build_model(Config(**NET_KW))
    torch.manual_seed(0)
    sd = {k: v + torch.randn_like(v.float()).to(v.dtype)
          if v.is_floating_point() else v
          for k, v in model.state_dict().items()}
    variables = chip_smoke.flax_variables(port_checkpoint, sd)
    payload = chip_smoke.jax_payload(variables, 3, 30, adam=True)
    payload["bf16"] = torch.tensor([1.5, -2.0, 0.25], dtype=torch.bfloat16)
    path = str(tmp_path / "ckpts" / "ckpt")
    chip_smoke.write_orbax(path, payload)
    _same_store(path)
    restored = ocp.StandardCheckpointer().restore(path)
    restored["opt_state"] = tuple(restored["opt_state"])
    ours = dict(payload)
    ours["bf16"] = jnp.asarray([1.5, -2.0, 0.25], jnp.bfloat16)
    _assert_same(jax.tree_util.tree_map(np.asarray, restored), ours)
    back = port_checkpoint.from_flax_variables(
        port_checkpoint.orbax_variables(str(tmp_path / "ckpts")))
    for k, v in sd.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(back[k], v), k
    assert sorted(jax_checkpoint.import_torch_state_dict(
        {k: v.numpy() for k, v in sd.items()})["params"]) == \
        sorted(variables["params"])
