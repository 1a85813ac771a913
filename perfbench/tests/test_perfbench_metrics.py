"""The per-layer and end-to-end arithmetic on synthetic event lists."""

from __future__ import annotations

import importlib.util

import numpy as np
import pytest
import torch

from perfbench.harness import bench, flops, trace
from perfbench.harness.trace import Event

METRICS = bench.ROOT / "perfbench" / "metrics"


def reader(name):
    spec = importlib.util.spec_from_file_location(
        f"m_{name.replace('.', '_')}", METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def make_run(cell, events=(), **counters):
    """A traced run whose two profiles both read ``events``."""
    return bench.Run(cell=bench.load_cell(cell), seed=1, seconds=1.0,
                     trace=True, device=torch.device("cpu"), t0=0.0,
                     events=list(events), device_events=list(events),
                     counters=counters)


def frame_events():
    """A 1 ms window with two frames: net spans, estimate spans, kernels
    and syncs."""
    return [
        Event(trace.WINDOW, "span", 0, 1_000_000),
        Event("perfbench.estimate", "span", 0, 400_000),
        Event("perfbench.net", "span", 0, 100_000),
        Event("cudaLaunchKernel", "runtime", 10_000, 12_000, corr=5),
        Event("aten::conv", "op", 20_000, 30_000, corr=900),
        Event("cudaStreamSynchronize", "runtime", 300_000, 350_000),
        Event("perfbench.estimate", "span", 500_000, 900_000),
        Event("cudaEventSynchronize", "runtime", 600_000, 610_000),
        Event("cudaDeviceSynchronize", "runtime", 950_000, 990_000),
        Event("conv_kernel", "device", 100_000, 200_000, corr=5),
        Event("cudnn_kernel", "device", 150_000, 300_000, corr=77,
              linked=900),
        Event("void vote_counts_kernel<256, 4, 1024>(float const*)",
              "device", 500_000, 600_000, corr=6),
        Event("Memcpy DtoH (Device -> Pageable)", "device", 650_000,
              660_000, corr=8),
    ]


def test_idle_share_and_busy_union():
    run = make_run("serve-3net-lm", frame_events(), frames=2)
    assert trace.busy_ns(run.events) == 200_000 + 100_000 + 10_000
    assert reader("device_idle_pct.serve")(run) == pytest.approx(69.0)
    assert reader("device_idle_pct.serve")(make_run("serve-3net-lm")) is None
    # the device-only profile has no spans: its window runs from the
    # first event to the last
    dev = [e for e in frame_events() if e.kind in ("device", "runtime")]
    run = make_run("serve-3net-lm")
    run.device_events = trace.with_window(dev)
    assert trace.window_ns(run.device_events) == 990_000 - 10_000
    assert reader("device_idle_pct.serve")(run) == pytest.approx(
        100 * (1 - 310_000 / 980_000))


def test_mfu_from_the_unprofiled_pass():
    run = make_run("serve-3net-lm", plain_s=2.0)
    frames = run.cell.workload["trace_frames"]
    want = 100 * 3 * flops.forward_flops(480, 640, 1) * frames / 2.0 / 989.4e12
    assert reader("mfu_pct.serve")(run) == pytest.approx(want)
    fused = make_run("serve-fused-lm", plain_s=2.0)
    assert reader("mfu_pct.serve")(fused) == pytest.approx(
        want / 3 * flops.forward_flops(480, 640, 3)
        / flops.forward_flops(480, 640, 1))
    assert reader("mfu_pct.serve")(make_run("serve-3net-lm")) is None


def test_k1_bound_counts_the_points_that_vote():
    run = make_run("serve-3net-lm", frame_events(), frames=2,
                   vote_points=[3000, 24000])
    pairs = 48 ** 3 * 3000 + 32 * 512 * 24000
    bound_s = pairs * 11 / (132 * 4 * 32 * 1.98e9)
    assert reader("k1_roofline")(run) == pytest.approx(
        100 * bound_s / 100e-6)


def test_p95_over_every_frame():
    run = make_run("serve-3net-lm")
    lat = list(np.linspace(0.01, 0.2, 200))
    run.window = {"seconds": 10.0, "frames": 200, "latencies_s": lat}
    assert reader("frame_p95_ms")(run) == pytest.approx(
        np.percentile(lat, 95) * 1e3)
    assert reader("frames_per_s")(run) == 20.0


def test_syncs_counted_inside_estimate_only():
    run = make_run("serve-3net-lm", frame_events(), frames=2)
    # two syncs inside the two estimate spans; the read outside is not
    assert reader("host_syncs_per_frame")(run) == 1.0


def test_net_device_time_by_correlation():
    run = make_run("serve-3net-lm", frame_events(), frames=2)
    # the kernel of the runtime launch and the one linked to the op
    assert reader("net_device_ms")(run) == pytest.approx(
        (100_000 + 150_000) / 1e6 / 2)
    assert reader("icp_device_ms")(run) is None


def test_spans_outside_the_window_do_not_count():
    """A frame served before the window (the profiler's settling frames)
    opens net, estimate and refine spans too; none of them counts."""
    before = [
        Event("perfbench.net", "span", -500_000, -400_000),
        Event("perfbench.estimate", "span", -500_000, -300_000),
        Event("perfbench.refine", "span", -300_000, -100_000),
        Event("cudaLaunchKernel", "runtime", -490_000, -480_000, corr=41),
        Event("cudaLaunchKernel", "runtime", -290_000, -280_000, corr=42),
        Event("cudaStreamSynchronize", "runtime", -350_000, -340_000),
        Event("conv_kernel", "device", -470_000, -20_000, corr=41),
        Event("icp_kernel", "device", -270_000, -10_000, corr=42),
    ]
    run = make_run("refine-3net-lm", before + frame_events(), frames=2)
    assert reader("net_device_ms")(run) == pytest.approx(
        (100_000 + 150_000) / 1e6 / 2)
    assert reader("host_syncs_per_frame")(run) == 1.0
    assert reader("icp_device_ms")(run) is None


def test_breakdown_names_ops_and_gaps():
    b = trace.breakdown(frame_events())
    assert b["device_ops"][0] == ["cudnn_kernel", 150_000 / 1e9]
    # each gap goes to the innermost host event around its middle
    assert dict(b["idle_gaps"]) == pytest.approx({
        "perfbench.net": 100e-6, "no host event": 200e-6,
        "perfbench.estimate": 50e-6 + 340e-6})
