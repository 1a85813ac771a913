"""What the serving drivers share: the cell's inputs from the seed, the
estimator under test (the program's ``PoseEstimator``, or the control in
its place), and the capture of a seeded sample of its outputs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from perfbench.harness import seeds, traffic, weights
from perfbench.reference import pose as ref_pose
from perfbench.reference.model import DenseFCNResNet152

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def settings(run):
    """The configuration's ``config`` with the run's overrides."""
    return {**run.cell.config["config"], **run.overrides}


def net_shape(conf):
    blocks = tuple(int(b) for b in conf["model_blocks"].split(",")) if (
        conf.get("model_blocks")) else (3, 8, 36, 3)
    return blocks, float(conf.get("model_width", 1.0))


def served_dtype(conf):
    return torch.bfloat16 if conf["compute_dtype"] == "bfloat16" else (
        torch.float32)


def normalize(image_u8):
    img = image_u8.to(torch.float32) / 255.0
    mean = torch.tensor(IMAGENET_MEAN, device=img.device)
    std = torch.tensor(IMAGENET_STD, device=img.device)
    return (img - mean) / std


@dataclasses.dataclass
class Inputs:
    """Everything a serving run draws from its seed."""
    images: np.ndarray        # (P, H, W, 3) uint8
    depths: np.ndarray        # (P, H, W) float32 mm
    areas: np.ndarray         # (P,) object pixels
    keypoints: np.ndarray     # (9, 3) m
    max_radii: np.ndarray     # (3,) dm
    k: np.ndarray             # (3, 3)
    cad_mm: np.ndarray | None  # (S, 3) for the refine traffic


def inputs(run):
    conf = settings(run)
    cfg, tr = run.cell.config, run.cell.traffic
    k = np.asarray(cfg["intrinsics"], np.float64)
    images, depths, areas = traffic.frames(
        tr, run.seed, conf["image_height"], conf["image_width"], k)
    refine = tr.get("refine")
    cad = (traffic.cad_cloud(run.seed, refine["cad_points"],
                             refine["cad_semi_axes_mm"]) if refine else None)
    return Inputs(images, depths, areas,
                  traffic.keypoints(run.seed, cfg["keypoints_std_m"]),
                  np.asarray(cfg["max_radii_dm"], np.float32), k, cad)


def net_weights(run, dtype):
    """The state dict of each net, on the run's device."""
    conf, cfg = settings(run), run.cell.config
    blocks, width = net_shape(conf)
    return [weights.make_net(run.seed, i, conf["kpt_heads"], cfg["head"],
                             dtype, run.device, blocks, width)
            for i in range(cfg["nets"])]


def reference_nets(run, dtype, quant=None):
    """The reference network of each net in float32, with the weights the
    program gets in ``dtype``, on the run's device."""
    conf = settings(run)
    blocks, width = net_shape(conf)
    nets = []
    for sd in net_weights(run, dtype):
        net = DenseFCNResNet152(conf["kpt_heads"], blocks, width, quant)
        net.load_state_dict(sd)
        nets.append(net.to(run.device))
    return nets


def program_estimator(run, inp):
    """The program's ``PoseEstimator`` with the seeded weights."""
    from rcvpose_tpu_torch import infer
    from rcvpose_tpu_torch.config import Config

    conf = settings(run)
    ws = net_weights(run, served_dtype(conf))
    return infer.PoseEstimator(
        Config(**conf), ws if len(ws) > 1 else ws[0], inp.keypoints,
        inp.max_radii, cad_mm=inp.cad_mm, k=inp.k, device=run.device)


class ControlEstimator:
    """The reference in the program's place, one precision step below the
    configuration's: fp8 convolutions, a bfloat16 vote and fit, TF32 in
    the ICP. ``estimate`` and ``refine`` as ``PoseEstimator``'s."""

    def __init__(self, run, inp):
        self.conf = settings(run)
        self.device = run.device
        self.models = [n.eval() for n in reference_nets(
            run, served_dtype(self.conf), quant="fp8")]
        put = lambda a: torch.as_tensor(  # noqa: E731
            np.asarray(a, np.float32), device=run.device)
        self.k, self.max_radii = put(inp.k), put(inp.max_radii)
        self.kpts_mm = put(inp.keypoints[1:4] * 1000.0)
        self.cad_mm = None if inp.cad_mm is None else put(inp.cad_mm)

    def estimate(self, image, depth):
        with torch.no_grad():
            x = normalize(torch.as_tensor(image, device=self.device))[None]
            segs, rads = zip(*[m(x) for m in self.models])
            sem = torch.cat([s[0].permute(2, 0, 1) for s in segs])
            rad = torch.cat([r[0].permute(2, 0, 1) for r in rads])
            return ref_pose.pose_from_maps(
                sem, rad, torch.as_tensor(depth, device=self.device), self.k,
                self.max_radii, self.kpts_mm, self.conf, low=True)

    def refine(self, result, threshold_mm, icp_iters):
        with torch.no_grad():
            return ref_pose.icp(self.cad_mm, result["scene_pts"],
                                result["scene_mask"], result["rt"],
                                threshold_mm, icp_iters, low=True)


class Sample:
    """A uniform seeded sample (reservoir) of ``size`` of the frames a
    window serves, with the maps each net gave for them: forward hooks
    keep each net's latest output, and ``offer`` files them with the
    frame's result when the frame is drawn."""

    def __init__(self, run, models, size):
        self.rng = seeds.rng(run.seed, "sample")
        self.size = size
        self.items = []
        self.seen = 0
        self.calls = 0
        self.latest = [None] * len(models)
        self.handles = [m.register_forward_hook(self._hook(i))
                        for i, m in enumerate(models)]

    def _hook(self, i):
        def hook(module, args, out):
            self.latest[i] = out
            self.calls += 1
        return hook

    def offer(self, pool_index, result, refined=None):
        n, self.seen = self.seen, self.seen + 1
        slot = n if n < self.size else int(self.rng.integers(0, n + 1))
        if slot >= self.size:
            return
        item = {"pool": pool_index, "maps": list(self.latest),
                "rt": result["rt"], "centers": result["centers"],
                "refined": refined}
        if slot < len(self.items):
            self.items[slot] = item
        else:
            self.items.append(item)

    def close(self):
        for h in self.handles:
            h.remove()
