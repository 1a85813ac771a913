"""The port's serving frame program against the JAX package's, end to end,
and the port's isolation from JAX.

Both ``PoseEstimator``s get the same weights (a Flax ``init`` at a seed,
carried into the port through ``checkpoint.from_flax_variables``) and the
same numpy frame, in f32 on the CPU.
"""

import ast
import dataclasses
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rcvpose_tpu import infer as jax_infer
from rcvpose_tpu import labels as jax_labels
from rcvpose_tpu import train as jax_train
from rcvpose_tpu.config import Config as JaxConfig
from rcvpose_tpu_torch import infer as port_infer
from rcvpose_tpu_torch.config import Config
from tests.torch_port_threads import port_threads  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parent.parent
HW = 64
SEM_THRESHOLD = 0.05
MAX_RADII = [0.5, 0.5, 0.5]
# The two frameworks' f32 forwards differ in the last bits (atol 1e-5 in
# test_torch_port_model.py). A pixel closer than MARGIN to the sem
# threshold or the radius clip, or whose voxel radius (dm * 20) lies closer
# than 20 * MARGIN to a half integer, could flip on that difference alone;
# ``_condition`` moves conv8's biases so that no used pixel does.
MARGIN = 1e-4


def _cfg(kpt_heads):
    return dict(compute_dtype="float32", vote_grid_l=64, max_points=256,
                image_height=HW, image_width=HW, model_blocks="1,1,1,1",
                model_width=0.125, kpt_heads=kpt_heads,
                sem_threshold=SEM_THRESHOLD)


def _frame(seed):
    rng = np.random.default_rng(seed)
    img = (rng.uniform(size=(HW, HW, 3)) * 255).astype(np.uint8)
    depth = np.zeros((HW, HW), np.float32)
    depth[18:46, 16:44] = rng.uniform(650.0, 750.0, size=(28, 28))
    keypoints = rng.normal(size=(9, 3)) * 0.05
    return img, depth, keypoints


def _maps(model, variables, img, depth):
    seg, rad = model.apply(variables, jax_labels.normalize_image(
        jnp.asarray(img))[None], False)
    used = depth > 0
    return np.asarray(seg)[0][used], np.asarray(rad)[0][used]  # (P, K)


def _margins(seg, rad):
    """Distances of the used pixels to the sem threshold, the radius clip
    (over masked pixels) and the rounding half-integers (over voting
    pixels, in voxels)."""
    sem = seg > SEM_THRESHOLD
    vote = sem & (rad <= MAX_RADII[0])
    rvox = rad[vote] * 20.0
    return (np.abs(seg - SEM_THRESHOLD).min(),
            np.abs(rad[sem] - MAX_RADII[0]).min(initial=1.0),
            np.abs(rvox - np.floor(rvox) - 0.5).min(initial=1.0) / 20.0)


def _condition(model, variables, img, depth):
    """Shift conv8's seg and radial biases per keypoint: the seg median onto
    the threshold and the radial median to half the clip, then on by small
    steps until every margin holds. Asserts the margins on the real maps."""
    seg, rad = _maps(model, variables, img, depth)
    bias = np.array(variables["params"]["conv8"]["bias"])
    k = seg.shape[1]
    for j in range(k):
        for step in range(400):
            ds = SEM_THRESHOLD - np.median(seg[:, j]) + 1.3e-3 * step
            dr = MAX_RADII[0] / 2 - np.median(rad[:, j]) + 0.7e-3 * step
            if min(_margins(seg[:, j] + ds, rad[:, j] + dr)) > 2 * MARGIN:
                break
        bias[j] += ds
        bias[k + j] += dr
    params = dict(variables["params"])
    params["conv8"] = {**params["conv8"], "bias": jnp.asarray(bias)}
    variables = {**variables, "params": params}
    seg, rad = _maps(model, variables, img, depth)
    assert min(_margins(seg, rad)) > MARGIN
    assert (seg > SEM_THRESHOLD).mean() > 0.2  # the masks are not empty
    return variables


@pytest.fixture(scope="module", params=[1, 3], ids=["3net", "fused"])
def estimators(request):
    kpt_heads = request.param
    jcfg = JaxConfig(**_cfg(kpt_heads))
    model = jax_train.build_model(jcfg)
    n_nets = 1 if kpt_heads > 1 else 3
    img, depth, keypoints = _frame(kpt_heads)
    variables = [
        _condition(model, model.init(jax.random.PRNGKey(i),
                                     jnp.zeros((1, HW, HW, 3)), False),
                   img, depth)
        for i in range(n_nets)]
    jax_est = jax_infer.PoseEstimator(jcfg, variables, keypoints, MAX_RADII)
    port_est = port_infer.PoseEstimator(
        Config(**_cfg(kpt_heads)),
        [jax.tree.map(np.asarray, v) for v in variables], keypoints,
        MAX_RADII, device="cpu")
    return jax_est, port_est, img, depth


def test_estimate_matches_jax(estimators):
    jax_est, port_est, img, depth = estimators
    want = jax_est.estimate(img, depth)
    got = port_est.estimate(img, depth)
    for key in ("escalate", "counts", "overflow", "cropped",
                "budget_exceeded", "union_count"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
    np.testing.assert_allclose(got["centers"].numpy(),
                               np.asarray(want["centers"]), atol=1e-2)
    # the point budget was outgrown and the frame escalated
    assert got["scene_pts"].shape[1] > port_est.cfg.max_points
    assert np.asarray(got["counts"]).min() > 0
    assert torch.isfinite(got["rt"]).all()


def test_estimate_batch_matches_single(estimators):
    _, port_est, img, depth = estimators
    small = np.zeros_like(depth)
    small[24:36, 24:36] = depth[24:36, 24:36]   # fits the point budget
    batch = port_est.estimate_batch(np.stack([img, img]),
                                    np.stack([small, depth]))
    for i, dep in enumerate((small, depth)):
        single = port_est.estimate(img, dep)
        torch.testing.assert_close(batch["centers"][i], single["centers"],
                                   rtol=0, atol=0)
        n = single["scene_pts"].shape[1]
        torch.testing.assert_close(batch["scene_pts"][i][:, :n],
                                   single["scene_pts"], rtol=0, atol=0)
        assert not batch["scene_mask"][i][:, n:].any()


def test_refine_matches_jax(estimators):
    """``PoseEstimator.refine`` against the JAX package's on the same
    frame result, with ``tests/test_infer.py``'s CAD (64 points, 40 mm
    spread), threshold 50 mm and 3 iterations; the default count is
    ``cfg.icp_iters``. Pose within 1e-3 mm and 1e-5."""
    import copy

    jax_est, port_est, img, depth = estimators
    cad_mm = np.random.default_rng(3).normal(size=(64, 3)) * 40.0
    jax_est, port_est = copy.copy(jax_est), copy.copy(port_est)
    jax_est.cad_mm = jnp.asarray(cad_mm, jnp.float32)
    port_est.cad_mm = torch.tensor(cad_mm, dtype=torch.float32)
    res = {k: np.asarray(v) for k, v in jax_est.estimate(img, depth).items()
           if k in ("rt", "scene_pts", "scene_mask")}
    for iters in (3, None):
        want = np.asarray(jax_est.refine(res, 50.0, icp_iters=iters))
        got = port_est.refine({k: torch.tensor(v) for k, v in res.items()},
                              50.0, icp_iters=iters).numpy()
        np.testing.assert_allclose(got[:3, :3], want[:3, :3], rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(got[:3, 3], want[:3, 3], rtol=0,
                                   atol=1e-3)
        assert not np.allclose(got, res["rt"])   # the ICP moved the pose
    port_est.cad_mm = None
    with pytest.raises(ValueError, match="cad_mm"):
        port_est.refine(res, 50.0)


def test_escalate_grows_budget_and_window():
    """_escalate: cropped -> full-frame re-run; budget_exceeded -> n_points
    doubles until the union fits, capped at the frame size."""
    est = port_infer.PoseEstimator.__new__(port_infer.PoseEstimator)
    est.cfg = Config(max_points=512)
    est.n_points = 512
    calls = []
    script = iter([(1.0, 1.0, 1500.0), (0.0, 1.0, 99999.0),
                   (0.0, 1.0, 99999.0)])

    def run(full, n_points):
        calls.append((full, n_points))
        return {"escalate": torch.tensor(next(script))}

    out = est._escalate(run, image_pixels=4096)
    assert calls == [(False, 512), (True, 2048), (True, 4096)]
    assert out["escalate"][1] > 0


def test_window_crop_escalates_to_full_frame(monkeypatch):
    """A mask larger than the packing window trips ``cropped`` and the frame
    re-runs with full-frame packing (perfect maps, no network)."""
    monkeypatch.setattr(port_infer, "WIN_H", 16)
    monkeypatch.setattr(port_infer, "WIN_W", 16)
    depth = torch.zeros(HW, HW)
    depth[8:56, 8:56] = 700.0
    sem = (depth > 0).float()[None].repeat(3, 1, 1)
    k = torch.tensor([[300.0, 0, 32], [0, 300.0, 32], [0, 0, 1]])
    args = (sem, sem, depth, k, torch.tensor([60.0] * 3), torch.zeros(3, 3))
    windowed = port_infer._pose_from_maps(*args, 0.5, 4096, 64, "hier",
                                          False)
    full = port_infer._pose_from_maps(*args, 0.5, 4096, 64, "hier", True)
    assert windowed["cropped"].all() and not full["cropped"].any()
    assert (full["counts"] > windowed["counts"]).all()


def test_suggest_pack_window_matches_jax():
    rng = np.random.default_rng(0)
    cad = rng.normal(size=(64, 3)) * 40.0
    k = jax_infer.geometry.LINEMOD_K
    assert (port_infer.suggest_pack_window(cad, k)
            == jax_infer.suggest_pack_window(cad, k))


def test_config_fields_match_jax():
    port = {f.name: f.default for f in dataclasses.fields(Config)}
    ref = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    assert port == ref


# ---------------------------------------------------------------------------
# Isolation: the port never reaches JAX or the JAX package
# ---------------------------------------------------------------------------

_FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "tensorstore",
              "zstandard", "rcvpose_tpu")


def _port_files():
    files = sorted((REPO / "rcvpose_tpu_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


def test_port_modules_import_without_jax():
    """A fresh interpreter imports every module of the port; neither JAX
    nor any module of the JAX package gets loaded."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import rcvpose_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "'rcvpose_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {_FORBIDDEN!r}]\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad or len(names) < 12 else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: p.relative_to(REPO).as_posix())
def test_port_source_imports_no_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in _FORBIDDEN, (path, name)


def test_estimator_without_device_raises_without_cuda():
    """No CUDA and no explicit CPU request: the entry point refuses to run
    rather than falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device exists")
    cfg = Config(**_cfg(1))
    with pytest.raises(RuntimeError, match="CUDA"):
        port_infer.PoseEstimator(cfg, [{}, {}, {}], np.zeros((9, 3)),
                                 MAX_RADII)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_infer.PoseEstimator(cfg, [{}, {}, {}], np.zeros((9, 3)),
                                 MAX_RADII, device="cuda")
