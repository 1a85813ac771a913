"""Cells at a size the CPU runs in seconds, for the harness's tests: the
network cut to one bottleneck a stage at an eighth of the width, 64 x 96
frames, grid 32 and 512 points. The checks' limits here are for this
size: the centres' and poses' are as the cells have them; the nets' map
error takes this size's own readings with room (bfloat16 on the CPU
reads up to 0.6 on maps whose spread is tiny at this width)."""

from __future__ import annotations

import time

import torch

from perfbench.harness import bench

SMALL = {"model_blocks": "1,1,1,1", "model_width": 0.125,
         "image_height": 64, "image_width": 96, "vote_grid_l": 32,
         "max_points": 512}
SERVE_LIMITS = {"maps_rel_err": 2.0}

def cell(name, root=bench.ROOT):
    c = bench.load_cell(name, root)
    c.traffic.update(pool=4, area_px=[150, 400], fit_hw=[40, 60])
    if "refine" in c.traffic:
        c.traffic["refine"]["cad_points"] = 200
    c.workload.update(warmup_frames=1, trace_frames=3)
    c.workload["check"]["frames"] = 3
    c.workload["check"]["limits"].update(SERVE_LIMITS)
    return c


def run(name, seed=2 ** 33 + 5, trace=False, control=False, seconds=0.5,
        root=bench.ROOT, device="cpu"):
    """A small run of ``name``: (result object, stderr lines, Run)."""
    r = bench.Run(cell=cell(name, root), seed=seed, seconds=seconds,
                  trace=trace, device=torch.device(device),
                  t0=time.perf_counter(), control=control, overrides=SMALL)
    bench.drive(r)
    out, lines = bench.result(r, device)
    return out, lines, r
