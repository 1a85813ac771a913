"""The inputs of a serving run whose frames each ask one class of many for
its pose, and the generator of their frames.

A configuration with ``classes`` (C) serves one estimator a class: class
``c`` has its own three nets (net ``3c + k`` of ``weights.make_net``), its
own keypoints (N(0, ``keypoints_std_m``) per axis, from its own stream)
and its own CAD cloud: ``cad["points"]`` points on an ellipsoid whose
longest semi-axis is spaced evenly over ``cad["longest_semi_axis_mm"]``
across the classes (the same for every seed) and whose others are
``cad["axis_ratios"]`` of it. Its packing window and point budget are the
configuration's where it gives them (non-zero), else derived here from
the CAD cloud, as the configuration's serving settings state them: the
bounding sphere about the cloud's mean, projected at ``pack_z_min_mm``
and padded by ``MARGIN`` in radius; the window its diameter in rows (fy)
and columns (fx), rounded up to 32; the budget its disc's area, rounded
up to 1,024 and capped at the window's area.

A multi-class traffic file (``perfbench/traffic/<name>.json``) holds:

* ``pool``: frames made at set-up, then cycled; a multiple of C, each
  class ``pool / C`` times, in a seeded order;
* ``depth_mm``: [lo, hi] distance of the object's nearest point, spaced
  as ``traffic.frames`` spaces them.

A frame holds one object of its class: an elliptical cap as
``traffic.frames`` draws it, whose semi-axes are the class ellipsoid's
two longest projected at the frame's depth, on uniform uint8 noise; only
the object's pixels have depth. It lies inside the class's window and
under its budget at any depth from ``pack_z_min_mm`` on.

A configuration without ``classes`` is one class with
``serving.inputs``' frames, keypoints and CAD cloud.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from perfbench.harness import seeds, serving, traffic

MARGIN = 1.2


@dataclasses.dataclass
class Inputs:
    """Everything a multi-class serving run draws from its seed."""
    images: np.ndarray        # (P, H, W, 3) uint8
    depths: np.ndarray        # (P, H, W) float32 mm
    areas: np.ndarray         # (P,) object pixels
    classes: np.ndarray       # (P,) the class each frame asks for
    keypoints: np.ndarray     # (C, 9, 3) m
    max_radii: np.ndarray     # (3,) dm
    k: np.ndarray             # (3, 3)
    cads: list                # C of (S, 3) mm, or None
    windows: list             # C of (rows, cols)
    budgets: list             # C of points


def n_classes(cfg):
    return int(cfg.get("classes", 1))


def semi_axes(cfg):
    """(C, 3) semi-axes (mm) of the classes' ellipsoids, longest first."""
    cad = cfg["cad"]
    lo, hi = cad["longest_semi_axis_mm"]
    longest = np.linspace(lo, hi, n_classes(cfg))
    return longest[:, None] * np.asarray(cad["axis_ratios"], np.float64)


def cad_cloud(seed, c, n, axes_mm):
    """(n, 3) points on class ``c``'s ellipsoid (mm, model frame)."""
    d = seeds.rng(seed, "cad", c).normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (d * np.asarray(axes_mm, np.float64)).astype(np.float32)


def _sphere_px(cad_mm, k, z_min_mm):
    """The CAD bounding sphere's radius at ``z_min_mm`` in rows and in
    columns (pixels), padded by ``MARGIN``."""
    cad = np.asarray(cad_mm)
    radius = float(np.linalg.norm(cad - cad.mean(axis=0), axis=1).max())
    k = np.asarray(k, np.float64)
    return tuple(radius / z_min_mm * float(f) * MARGIN
                 for f in (k[1, 1], k[0, 0]))


def window(cad_mm, k, z_min_mm):
    """(rows, cols) of the packing window: the padded sphere's diameter,
    rounded up to 32."""
    return tuple(int(math.ceil(max(2.0 * r, 1.0) / 32.0)) * 32
                 for r in _sphere_px(cad_mm, k, z_min_mm))


def budget(cad_mm, k, z_min_mm, win):
    """Points of the budget: the padded sphere's disc, rounded up to 1,024,
    at most the window's area."""
    rows, cols = _sphere_px(cad_mm, k, z_min_mm)
    disc = max(math.pi * rows * cols, 1.0)
    return min(int(math.ceil(disc / 1024.0)) * 1024, win[0] * win[1])


def frames(params, seed, h, w, k, axes_mm):
    """(images (P, H, W, 3) uint8, depths (P, H, W) float32 mm, areas (P,)
    valid-depth pixels, classes (P,)) for ``seed``; ``k`` the 3x3
    intrinsics, ``axes_mm`` the classes' (C, 3) semi-axes."""
    n, n_cls = int(params["pool"]), len(axes_mm)
    if n % n_cls:
        raise ValueError(f"pool {n} is not a multiple of {n_cls} classes")
    rng = seeds.rng(seed, "frames")
    classes = rng.permutation(np.arange(n) % n_cls)
    z0s = traffic._spaced(*params["depth_mm"], n, rng)
    fx, fy = float(k[0][0]), float(k[1][1])
    images = rng.integers(0, 256, size=(n, h, w, 3), dtype=np.uint8)
    depths = np.zeros((n, h, w), np.float32)
    got = np.zeros(n, np.int64)
    rows = np.arange(h, dtype=np.float64)[:, None]
    cols = np.arange(w, dtype=np.float64)[None, :]
    for i in range(n):
        a_mm, b_mm = axes_mm[classes[i]][:2]       # columns, rows
        if rng.uniform() < 0.5:
            a_mm, b_mm = b_mm, a_mm
        a, b = a_mm * fx / z0s[i], b_mm * fy / z0s[i]
        rc = rng.uniform(b + 1, h - b - 1)
        cc = rng.uniform(a + 1, w - a - 1)
        rho2 = ((rows - rc) / b) ** 2 + ((cols - cc) / a) ** 2
        inside = rho2 < 1.0
        # the cap's depth relief, as traffic.frames gives it
        radius_mm = np.sqrt(a * b) * z0s[i] / fx
        z = z0s[i] + 0.5 * radius_mm * (1.0 - np.sqrt(
            np.clip(1.0 - rho2, 0.0, 1.0)))
        depths[i] = np.where(inside, np.round(z), 0.0)
        got[i] = int(inside.sum())
    return images, depths, got, classes


def inputs(run):
    """The run's ``Inputs``: each class's window and budget as the
    configuration gives them, else derived from its CAD cloud."""
    conf, cfg = serving.settings(run), run.cell.config
    if "classes" not in cfg:
        one = serving.inputs(run)
        return _with_settings(conf, Inputs(
            one.images, one.depths, one.areas,
            np.zeros(len(one.images), np.int64), one.keypoints[None],
            one.max_radii, one.k, [one.cad_mm], [], []))
    k = np.asarray(cfg["intrinsics"], np.float64)
    axes = semi_axes(cfg)
    images, depths, areas, classes = frames(
        run.cell.traffic, run.seed, conf["image_height"],
        conf["image_width"], k, axes)
    std = cfg["keypoints_std_m"]
    keypoints = np.zeros((len(axes), 9, 3))
    for c in range(len(axes)):
        keypoints[c, 1:4] = seeds.rng(run.seed, "keypoints", c).normal(
            size=(3, 3)) * std
    cads = [cad_cloud(run.seed, c, cfg["cad"]["points"], axes[c])
            for c in range(len(axes))]
    return _with_settings(conf, Inputs(
        images, depths, areas, classes, keypoints,
        np.asarray(cfg["max_radii_dm"], np.float32), k, cads, [], []))


def _with_settings(conf, inp):
    # the derivation reads the intrinsics in the precision the program
    # gets them, float32
    k32 = inp.k.astype(np.float32)
    z_min = float(conf.get("pack_z_min_mm", 600.0))
    for cad in inp.cads:
        win = (conf["pack_win_h"], conf["pack_win_w"])
        if not (win[0] > 0 and win[1] > 0):
            win = window(cad, k32, z_min)
        inp.windows.append(tuple(int(v) for v in win))
        inp.budgets.append(int(conf["max_points"])
                           or budget(cad, k32, z_min, win))
    return inp
