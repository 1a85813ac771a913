"""The readers of the program's spans and counters, on synthetic event
lists and a stand-in for the program's ``profiling`` module: launches
inside and outside the spans, clipping to the window, and None where the
program has no spans (as the parent commit's program, or ``--control
1``, which builds no ``PoseEstimator``)."""

from __future__ import annotations

import sys
import types

import pytest

from perfbench.harness import trace
from perfbench.harness.trace import Event
from perfbench.tests.test_perfbench_metrics import make_run, reader

CELLS = ("serve-3net-lm", "serve-fused-lm", "refine-3net-lm")


def program_events():
    """Two frames in a 1 ms window, and one settling frame before it:
    net, pose and refine spans with the launches inside and around them."""
    return [
        Event("rcvpose.net", "span", -300_000, -200_000),      # settling
        Event("cudaLaunchKernel", "runtime", -250_000, -249_000, corr=1),
        Event(trace.WINDOW, "span", 0, 1_000_000),
        Event("rcvpose.estimate", "span", 0, 400_000),
        Event("rcvpose.net", "span", 10_000, 100_000),
        Event("cudaLaunchKernel", "runtime", 20_000, 21_000, corr=2),
        Event("cuLaunchKernelEx", "runtime", 30_000, 31_000, corr=3),
        Event("cudaMemcpyAsync", "runtime", 40_000, 41_000, corr=4),
        Event("rcvpose.pose", "span", 150_000, 300_000),
        Event("cudaLaunchKernel", "runtime", 160_000, 161_000, corr=5),
        Event("aten::sort", "op", 170_000, 180_000, corr=900),
        Event("cudaLaunchKernel", "runtime", 350_000, 351_000, corr=6),
        Event("rcvpose.refine", "span", 400_000, 450_000),
        Event("cudaLaunchKernelExC", "runtime", 410_000, 411_000, corr=7),
        Event("rcvpose.estimate", "span", 500_000, 900_000),
        Event("rcvpose.net", "span", 510_000, 600_000),
        Event("cudaLaunchKernel", "runtime", 520_000, 521_000, corr=8),
        Event("rcvpose.pose", "span", 650_000, 800_000),
        Event("cudaLaunchKernel", "runtime", 660_000, 661_000, corr=9),
        Event("k_settle", "device", -240_000, -230_000, corr=1),
        Event("k_net", "device", 100_000, 140_000, corr=2),
        Event("k_pose", "device", 300_000, 320_000, corr=5),
        Event("k_sort", "device", 320_000, 330_000, corr=77, linked=900),
        Event("k_outside", "device", 360_000, 380_000, corr=6),
        Event("k_pose2", "device", 700_000, 730_000, corr=9),
    ]


def test_launches_inside_the_spans_per_frame():
    run = make_run("refine-3net-lm", program_events(), frames=2)
    # net: two launches in frame 1 (runtime and driver), one in frame 2;
    # the copy, the launch between spans and the settling frame's are out
    assert reader("launches_per_frame.net")(run) == pytest.approx(1.5)
    assert reader("launches_per_frame.pose")(run) == pytest.approx(1.0)
    assert reader("launches_per_frame.refine")(run) == pytest.approx(0.5)
    # a cell whose frames are not refined: the program's spans, no refine
    served = [e for e in program_events() if e.name != "rcvpose.refine"]
    run = make_run("serve-3net-lm", served, frames=2)
    assert reader("launches_per_frame.refine")(run) == 0.0


def test_pose_device_ms_counts_kernels_launched_in_pose_spans():
    run = make_run("serve-3net-lm", program_events(), frames=2)
    # k_pose 20 us, k_sort 10 us (by its operator), k_pose2 30 us
    assert reader("pose_device_ms")(run) == pytest.approx(0.030)


def test_readers_of_the_trace_are_none_without_program_spans():
    bare = [e for e in program_events() if not e.name.startswith("rcvpose.")]
    for events in (bare, []):
        run = make_run("refine-3net-lm", events, frames=2)
        for name in ("launches_per_frame.net", "launches_per_frame.pose",
                     "launches_per_frame.refine", "pose_device_ms"):
            assert reader(name)(run) is None, name


def program(monkeypatch, counters=None, startup=None):
    """A stand-in for ``rcvpose_tpu_torch.profiling`` (None: the module
    lacks that function, as the parent commit's does)."""
    mod = types.ModuleType("rcvpose_tpu_torch.profiling")
    if counters is not None:
        mod.counters = lambda: dict(counters)
    if startup is not None:
        mod.startup = lambda: list(startup)
    monkeypatch.setitem(sys.modules, "rcvpose_tpu_torch.profiling", mod)


def test_escalations_per_frame(monkeypatch):
    run = make_run("serve-fused-lm")
    program(monkeypatch, counters={"frames": 40, "escalations.cropped": 3,
                                   "escalations.budget": 1,
                                   "kernels.loaded": 3})
    assert reader("escalations_per_frame")(run) == pytest.approx(0.1)
    program(monkeypatch, counters={"frames": 40})
    assert reader("escalations_per_frame")(run) == 0.0
    for counts in ({}, None):    # no frame served; no counters at all
        program(monkeypatch, counters=counts)
        assert reader("escalations_per_frame")(run) is None
    monkeypatch.delitem(sys.modules, "rcvpose_tpu_torch.profiling")
    assert reader("escalations_per_frame")(run) is None


def span(name, start_s, end_s, parent=None):
    return types.SimpleNamespace(name=name, start_ns=int(start_s * 1e9),
                                 end_ns=int(end_s * 1e9), parent=parent,
                                 attrs={})


def test_startup_readers(monkeypatch):
    run = make_run("serve-3net-lm")
    record = [span("rcvpose.load", 1.0, 2.5), span("rcvpose.load", 2.5, 3.0),
              span("rcvpose.estimate", 4.0, 5.75),
              span("rcvpose.kernels.load", 4.5, 4.625, parent=2),
              span("rcvpose.kernels.load", 5.0, 5.25, parent=2),
              span("rcvpose.estimate", 6.0, 6.5)]
    program(monkeypatch, startup=record)
    assert reader("net_load_s")(run) == pytest.approx(2.0)
    assert reader("kernel_load_s")(run) == pytest.approx(0.375)
    assert reader("first_frame_s")(run) == pytest.approx(1.75)
    for startup in ([], None):
        program(monkeypatch, startup=startup)
        for name in ("net_load_s", "kernel_load_s", "first_frame_s"):
            assert reader(name)(run) is None, name


def test_the_new_metrics_belong_to_the_cells_that_list_them():
    from perfbench.harness import bench

    new = {"launches_per_frame.net", "launches_per_frame.pose",
           "launches_per_frame.refine", "pose_device_ms",
           "escalations_per_frame", "net_load_s", "kernel_load_s",
           "first_frame_s"}
    for cell in CELLS:
        names = {m["name"] for m in bench.load_cell(cell).per_layer}
        assert new <= names, cell
