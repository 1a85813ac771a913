"""The one generator of the benchmark's inputs: RGB-D frames with one
object.

A traffic file (``perfbench/traffic/<name>.json``) holds only numbers:

* ``pool``: frames made at set-up, then cycled;
* ``area_px``: [lo, hi] valid-depth area of the object. Every seed gets
  the same set of areas, ``lo + (hi - lo) (i + 0.5) / pool``, in its own
  order, so seeds change where and what, not how much;
* ``depth_mm``: [lo, hi] distance of the object's nearest point, spaced
  the same way;
* ``aspect``: [lo, hi] ratio of the ellipse's axes;
* ``fit_hw``: the box (rows, cols) the object's extent stays inside, so
  the program's packing window (of that size) holds the whole object;
* optionally ``refine`` (ICP after each frame: ``iters``,
  ``threshold_mm``, ``cad_points``, ``cad_semi_axes_mm``).

The object is an elliptical cap (a half ellipsoid facing the camera)
whose depth is rounded to whole millimetres, as a depth camera gives it;
the image is uniform uint8 noise. Every pixel outside the object has no
depth, so the voting region is the object's pixels.
"""

from __future__ import annotations

import numpy as np

from perfbench.harness import seeds


def _spaced(lo, hi, n, rng):
    """The same ``n`` values for every seed, in a seeded order."""
    vals = lo + (hi - lo) * (np.arange(n) + 0.5) / n
    return vals[rng.permutation(n)]


def frames(params, seed, h, w, k):
    """(images (N, H, W, 3) uint8, depths (N, H, W) float32 mm, areas (N,)
    valid-depth pixels) for ``seed``; ``k`` the 3x3 intrinsics."""
    n = int(params["pool"])
    rng = seeds.rng(seed, "frames")
    areas = _spaced(*params["area_px"], n, rng)
    z0s = _spaced(*params["depth_mm"], n, rng)
    fit_h, fit_w = (min(a, b) for a, b in zip(params["fit_hw"], (h, w)))
    images = rng.integers(0, 256, size=(n, h, w, 3), dtype=np.uint8)
    depths = np.zeros((n, h, w), np.float32)
    got = np.zeros(n, np.int64)
    rows = np.arange(h, dtype=np.float64)[:, None]
    cols = np.arange(w, dtype=np.float64)[None, :]
    for i in range(n):
        aspect = rng.uniform(*params["aspect"])
        a = np.sqrt(areas[i] / (np.pi * aspect))      # column semi-axis
        b = a * aspect                                # row semi-axis
        if rng.uniform() < 0.5:
            a, b = b, a
        # keep the extent (2b + 2 rows, 2a + 2 cols) inside the fit box
        b = min(b, fit_h / 2 - 2)
        a = min(a, fit_w / 2 - 2)
        rc = rng.uniform(b + 1, h - b - 1)
        cc = rng.uniform(a + 1, w - a - 1)
        rho2 = ((rows - rc) / b) ** 2 + ((cols - cc) / a) ** 2
        inside = rho2 < 1.0
        # a cap whose depth relief is half its radius in millimetres
        radius_mm = np.sqrt(a * b) * z0s[i] / float(k[0][0])
        z = z0s[i] + 0.5 * radius_mm * (1.0 - np.sqrt(
            np.clip(1.0 - rho2, 0.0, 1.0)))
        depths[i] = np.where(inside, np.round(z), 0.0)
        got[i] = int(inside.sum())
    return images, depths, got


def keypoints(seed, std_m):
    """(9, 3) model-frame keypoints (m); rows 1-3 are the voted ones."""
    kp = np.zeros((9, 3))
    kp[1:4] = seeds.rng(seed, "keypoints").normal(size=(3, 3)) * std_m
    return kp


def cad_cloud(seed, n, semi_axes_mm):
    """(n, 3) points on an ellipsoid's surface (mm, model frame)."""
    rng = seeds.rng(seed, "cad")
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (d * np.asarray(semi_axes_mm, np.float64)).astype(np.float32)
