"""Many classes in one serving process (``infer.PoseEstimator``): a point
budget derived from each class's geometry, nets built on their device
from the caller's weights, and one graph pool that the classes' estimators
share (``PoseEstimator(..., graph_pool=)``, ``serve.PoseServer``).

The CPU cases run everywhere. The ``cuda`` case needs an NVIDIA card and
``nvcc`` and skips elsewhere; the file imports neither JAX nor the JAX
package, so the card's machine runs it:

    python -m pytest -o addopts="" --noconftest -m cuda \\
        tests/test_torch_port_classes.py -q
"""

import math

import numpy as np
import pytest
import torch

from rcvpose_tpu_torch import geometry, infer, profiling, serve, train
from rcvpose_tpu_torch.models import folded, graphs
from tests.torch_port_estimators import (_weights, config, estimator,
                                         frame)
from tests.torch_port_threads import port_threads  # noqa: F401


def _ellipsoid(longest_mm, n=400, seed=0):
    d = np.random.default_rng(seed).normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (d * np.array([1.0, 0.75, 0.5]) * longest_mm).astype(np.float32)


def _count(name):
    return profiling.counters().get(name, 0)


def _equal_results(a, b):
    assert list(a) == list(b)
    for key in a:
        assert a[key].dtype == b[key].dtype, key
        assert torch.equal(a[key], b[key]), key


def _old_load(est, weights):
    """The folded net as ``PoseEstimator._load`` built it before nets were
    built on their device: f32 on the CPU with PyTorch's init, the
    weights copied in, then moved, cast and folded."""
    model = train.build_model(est.cfg)
    model.load_state_dict(weights)
    return folded.fold_for_serving(
        model.to(device=est.device, dtype=est.dtype,
                 memory_format=torch.channels_last).eval())


@pytest.mark.parametrize("cad_mm,win", [
    (_ellipsoid(40.0), None), (_ellipsoid(120.0), None),
    (_ellipsoid(120.0), (64, 96))])
def test_derived_budget_covers_the_projected_disc(cad_mm, win):
    k = geometry.LINEMOD_K
    win = win or infer.suggest_pack_window(cad_mm, k, 600.0)
    got = infer.suggest_point_budget(cad_mm, k, win, 600.0)
    center = cad_mm.mean(axis=0)
    radius = float(np.linalg.norm(cad_mm - center, axis=1).max())
    disc = math.pi * (radius / 600.0 * 1.2) ** 2 * k[0, 0] * k[1, 1]
    assert got % 1024 == 0
    if win[0] * win[1] < disc:
        assert got == win[0] * win[1]
    else:
        assert disc <= got < disc + 1024
    # an object at twice the distance covers a quarter: the same budget
    assert infer.suggest_point_budget(cad_mm, k, win, 1200.0) <= got


def test_estimator_derives_its_budget_only_without_one():
    cad = _ellipsoid(40.0)
    derived = estimator(1, cad_mm=cad, max_points=0)
    want = infer.suggest_point_budget(
        cad, geometry.LINEMOD_K.astype(np.float32), derived.win_hw, 600.0)
    assert derived.n_points == want > 1024
    assert estimator(1, cad_mm=cad).n_points == config(1).max_points


@pytest.mark.parametrize("max_points", [0, -1])
def test_no_budget_and_no_cad_raises(max_points):
    with pytest.raises(ValueError, match="max_points"):
        estimator(1, max_points=max_points)


@pytest.mark.parametrize("kpt_heads", [1, 3], ids=["3net", "fused"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nets_built_on_the_device_equal_the_old_route(kpt_heads, dtype):
    """Each net equals the CPU-init route's folded net bit for bit: every
    buffer's dtype, strides and values, and the forward."""
    est = estimator(kpt_heads, dtype=dtype)
    x = torch.randn(1, 64, 64, 3, generator=torch.Generator().manual_seed(0))
    for m, w in zip(est.models, _weights(kpt_heads)):
        old = _old_load(est, w)
        want, got = old.state_dict(), m.net.state_dict()
        assert list(want) == list(got)
        for key in want:
            a, b = want[key], got[key]
            assert a.dtype == b.dtype and a.stride() == b.stride(), key
            assert torch.equal(a, b), key
        with torch.inference_mode():
            for a, b in zip(old(x), m.net(x)):
                assert torch.equal(a, b)


def test_nets_hold_copies_of_the_callers_weights():
    w = _weights(1)[0]
    est = estimator(1)
    for name, t in est.models[0].net.state_dict().items():
        assert all(t.data_ptr() != v.data_ptr() for v in w.values()), name


@pytest.mark.parametrize("kpt_heads", [1, 3], ids=["3net", "fused"])
def test_explicit_budget_gives_the_old_result(kpt_heads, monkeypatch):
    """An explicit ``max_points`` (every LM configuration) serves as the
    old route did: the same nets, budget and pose, bit for bit."""
    est = estimator(kpt_heads)
    assert est.n_points == est.cfg.max_points
    monkeypatch.setattr(infer.PoseEstimator, "_load",
                        lambda self, i, w: _old_load(self, w))
    old = estimator(kpt_heads)
    for seed in (2, 3):
        img, depth = frame(seed)
        _equal_results(est.estimate(img, depth), old.estimate(img, depth))
    imgs, deps = (np.stack(a) for a in zip(frame(4), frame(5)))
    _equal_results(est.estimate_batch(imgs, deps),
                   old.estimate_batch(imgs, deps))


@pytest.mark.parametrize("batch", [False, True])
def test_frame_inside_the_derived_budget_never_escalates(batch):
    est = estimator(1, cad_mm=_ellipsoid(40.0), max_points=0)
    frames = [frame(s, patch=40) for s in (6, 7)]
    before = {r: _count(f"escalations.{r}") for r in ("cropped", "budget")}
    if batch:
        imgs, deps = (np.stack(a) for a in zip(*frames))
        results = [est.estimate_batch(imgs, deps)]
        n_pts = [r["scene_pts"].shape[2] for r in results]
    else:
        results = [est.estimate(img, depth) for img, depth in frames]
        n_pts = [r["scene_pts"].shape[1] for r in results]
    assert all(n == est.n_points > 40 * 40 for n in n_pts)
    for r in results:
        assert not r["budget_exceeded"].any() and not r["cropped"].any()
    assert {r: _count(f"escalations.{r}") for r in before} == before


def test_estimate_span_carries_the_budget(monkeypatch):
    monkeypatch.setattr(profiling, "_startup", profiling.Startup())
    est = estimator(1, cad_mm=_ellipsoid(40.0), max_points=0)
    est.estimate(*frame(8))
    spans = [s for s in profiling.startup() if s.name == "rcvpose.estimate"]
    assert spans and spans[0].attrs["n_points"] == est.n_points


def test_classes_on_one_pool_give_their_own_results():
    """Two classes' estimators on one pool serve their own frames as
    estimators with pools of their own do; the second joined the pool."""
    pool = graphs.GraphPool()
    joined = _count("graphs.pool.joined")
    a = estimator(1, graph_pool=pool)
    b = estimator(1, seed=1, graph_pool=pool)
    assert _count("graphs.pool.joined") == joined + 1
    caches = [c for e in (a, b) for c in (
        *[m._graphs for m in e.models], e._pose, e._icp)]
    assert all(c.pool is pool for c in caches)
    alone = [estimator(1), estimator(1, seed=1)]
    assert alone[0].models[0].pool is not alone[1].models[0].pool
    for seed, (shared, own) in zip((9, 10, 11), ((a, alone[0]),
                                                 (b, alone[1]),
                                                 (a, alone[0]))):
        img, depth = frame(seed)
        _equal_results(shared.estimate(img, depth), own.estimate(img, depth))
    img, depth = frame(12)
    assert not torch.equal(a.estimate(img, depth)["centers"],
                           b.estimate(img, depth)["centers"])


def test_joining_a_pool_moves_every_cache_and_drops_its_graphs():
    est = estimator(1)
    rep = est.replicate_to("cpu")
    assert rep.models[0].pool is not est.models[0].pool
    est._pose[("key",)] = object()
    pool = graphs.GraphPool()
    est.join_graph_pool(pool)
    caches = [m._graphs for m in est.models] + [est._pose, est._icp]
    assert all(c.pool is pool and c == {} for c in caches)


def test_server_puts_every_class_in_one_pool_a_device():
    default = estimator(1)
    joined = _count("graphs.pool.joined")
    srv = serve.PoseServer(default, class_name="a",
                           estimator_factory=lambda name: estimator(
                               1, seed=len(name)),
                           devices=[torch.device("cpu")])
    srv.warm_classes(["bb", "ccc"])
    pools = {id(srv._pools[name].replicas[0].models[0].pool)
             for name in ("a", "bb", "ccc")}
    assert pools == {id(default.models[0].pool)}
    assert _count("graphs.pool.joined") == joined + 2


# ---------------------------------------------------------------------------
# The card: interleaved replays of three classes on one pool
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU mode")
    return torch.device("cuda")


def _card_frame(seed, h=480, w=640, patch=48):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
    depth = np.zeros((h, w), np.float32)
    r0, c0 = (h - patch) // 2, (w - patch) // 2
    depth[r0:r0 + patch, c0:c0 + patch] = rng.uniform(650.0, 750.0,
                                                      size=(patch, patch))
    return img, depth


def _pool_bytes(pool):
    """Device memory in the segments of ``pool``'s graph memory pool."""
    torch.cuda.synchronize()
    handle = tuple(pool.handle())
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg["segment_pool_id"]) == handle)


def _out_bytes(est):
    """Bytes of the static outputs that ``est``'s graphs hold."""
    caches = [m._graphs for m in est.models] + [est._pose, est._icp]
    outs = [g.out for c in caches for g in c.values()]
    flat = [t for o in outs for t in (o if isinstance(o, tuple) else (o,))]
    return sum(t.untyped_storage().nbytes() for t in flat)


@pytest.mark.cuda
def test_three_classes_interleaved_on_one_pool(cuda):
    """Classes A, B and C on one pool, captured and then replayed A B C A C
    B at 480 x 640: each frame equals its class's estimator with a pool of
    its own; two estimators joined; the shared pool holds one estimator's
    graph memory plus the other two's static outputs (within one 20 MiB
    segment of the allocator's rounding), less than the three own pools."""
    kw = dict(device=None, dtype="bfloat16", cad_mm=_ellipsoid(60.0),
              max_points=0)
    frames = {s: _card_frame(s) for s in range(6)}
    alone = [estimator(1, seed=c, **kw) for c in range(3)]
    wants = {}
    for c, est in enumerate(alone):
        est.estimate(*frames[c])               # eager and capture
        for s in range(6):
            wants[c, s] = est.estimate(*frames[s])
    sizes = [_pool_bytes(e.models[0].pool) for e in alone]
    outs = [_out_bytes(e) for e in alone]
    del alone

    joined = _count("graphs.pool.joined")
    pool = graphs.GraphPool()
    shared = [estimator(1, seed=c, graph_pool=pool, **kw) for c in range(3)]
    assert _count("graphs.pool.joined") == joined + 2
    order = [0, 1, 2, 0, 2, 1]
    for c in order[:3]:                        # captures, interleaved
        shared[c].estimate(*frames[c])
    for s, c in enumerate(order):              # replays, interleaved
        _equal_results(shared[c].estimate(*frames[s]), wants[c, s])
    got = _pool_bytes(pool)
    print(f"pool bytes: shared {got}, own {sizes}, outputs {outs}")
    assert 0 < got < sum(sizes)
    assert got <= sizes[0] + outs[1] + outs[2] + 20 * 2 ** 20
