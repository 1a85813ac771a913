"""The plain reference against ``rcvpose_tpu_torch`` on the CPU at a small
size: the net's forward, the masks and packing, the
hier vote, Horn's fit and ICP. The reference is a frozen copy of the
published arithmetic; these tests show it still computes what the
program computes."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from perfbench.harness import serving, traffic, weights
from perfbench.reference import pose as ref_pose
from perfbench.reference.model import DenseFCNResNet152
from rcvpose_tpu_torch import fit, infer
from rcvpose_tpu_torch import train as port_train
from rcvpose_tpu_torch.config import Config
from rcvpose_tpu_torch.ops import voting

BLOCKS, WIDTH = (1, 1, 1, 1), 0.125
HEAD = {"seg_bias": 5.0, "seg_std": 1.0, "radial_bias": 1.0,
        "radial_std": 0.15, "feature_rms": 0.3}
K = np.array([[572.4114, 0, 48.0], [0, 573.57043, 32.0], [0, 0, 1.0]],
             np.float32)


@pytest.fixture(autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def nets(kpt_heads, seed=3):
    sd = weights.make_net(seed, 0, kpt_heads, HEAD, torch.float32, "cpu",
                          BLOCKS, WIDTH)
    cfg = Config(kpt_heads=kpt_heads, model_blocks="1,1,1,1",
                 model_width=WIDTH, compute_dtype="float32")
    port = port_train.build_model(cfg)
    port.load_state_dict(sd)
    ref = DenseFCNResNet152(kpt_heads, BLOCKS, WIDTH)
    ref.load_state_dict(sd)
    return port, ref, cfg


@pytest.mark.parametrize("kpt_heads", [1, 3])
def test_forward_matches_the_port(kpt_heads):
    port, ref, _ = nets(kpt_heads)
    x = torch.randn(2, 64, 96, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got = port.eval()(x)
        want = ref.eval()(x)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


def frame(seed=5):
    params = {"pool": 1, "area_px": [250, 400], "depth_mm": [600, 1200],
              "aspect": [0.6, 1.0], "fit_hw": [40, 60]}
    images, depths, _ = traffic.frames(params, seed, 64, 96, K)
    return images[0], depths[0]


def test_pose_from_maps_matches_the_port_exactly():
    _, ref, _ = nets(3)
    image, depth = frame()
    with torch.no_grad():
        seg, rad = ref.eval()(serving.normalize(torch.as_tensor(image))[None])
    sem_maps, rad_maps = seg[0].permute(2, 0, 1), rad[0].permute(2, 0, 1)
    depth_t = torch.as_tensor(depth)
    k = torch.as_tensor(K)
    max_r = torch.tensor([2.0, 2.2, 2.4])
    kpts = torch.randn(3, 3, generator=torch.Generator().manual_seed(4)) * 50
    conf = {"sem_threshold": 0.8, "max_points": 512, "vote_grid_l": 32,
            "vote_topk": 32, "vote_cpt_stride": 8, "vote_win": 8,
            "pack_win_h": 48, "pack_win_w": 64}
    want = infer._pose_from_maps(sem_maps, rad_maps, depth_t, k, max_r,
                                 kpts, 0.8, 512, 32, "hier", False, 32, 8,
                                 8, (48, 64))
    got = ref_pose.pose_from_maps(sem_maps, rad_maps, depth_t, k, max_r,
                                  kpts, conf)
    assert int(want["counts"].min()) > 200
    for key in ("rt", "centers", "counts"):
        assert torch.equal(got[key], want[key]), key
    assert torch.equal(got["scene_pts"], want["scene_pts"].reshape(-1, 3))
    assert torch.equal(got["scene_mask"], want["scene_mask"].reshape(-1))
    low = ref_pose.pose_from_maps(sem_maps, rad_maps, depth_t, k, max_r,
                                  kpts, conf, low=True)
    assert not torch.equal(low["rt"], want["rt"])


def test_hier_vote_matches_the_port_exactly():
    g = torch.Generator().manual_seed(6)
    n = 300
    pts = torch.randn(3, n, 3, generator=g) * 0.03 + torch.tensor(
        [0.05, -0.02, 0.8])
    radial = torch.rand(3, n, generator=g) * 1.5 + 0.3
    mask = torch.rand(3, n, generator=g) > 0.1
    want = voting.accumulate_3d(pts, radial, mask, grid_l=32, mode="hier",
                                topk=16, cpt_stride=4, win=8)
    got = ref_pose.hier_vote(pts, radial, mask, 32, 16, 4, 8)
    assert torch.equal(got, want.center_mm)


def test_fit_and_icp_match_the_port_exactly():
    g = torch.Generator().manual_seed(7)
    p1 = torch.randn(50, 3, generator=g) * 40
    rt_true = fit.horn_fit(p1[:3], p1[:3] + torch.tensor([5.0, -3.0, 2.0]))
    p2 = p1 @ rt_true[:3, :3].T + rt_true[:3, 3] + torch.randn(
        50, 3, generator=g)
    assert torch.equal(ref_pose.horn_fit(p1, p2), fit.horn_fit(p1, p2))
    scene = torch.cat([p2, torch.randn(30, 3, generator=g) * 60])
    mask = torch.rand(80, generator=g) > 0.2
    init = torch.eye(4)
    want = fit.icp_point_to_point(p1, scene, mask, init, 30.0, max_iters=10)
    got = ref_pose.icp(p1, scene, mask, init, 30.0, 10)
    assert torch.equal(got, want)
