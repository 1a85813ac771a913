"""The nets' convolution FLOPs of the traced run's unprofiled pass, over
its seconds on the host clock, as a share of the card's dense bf16 peak,
in percent. The FLOPs a frame are counted from the layer shapes
(``harness.flops``)."""

from perfbench.harness import flops, serving


def read(run):
    seconds = run.counters.get("plain_s")
    if not seconds:
        return None
    conf = serving.settings(run)
    blocks, width = serving.net_shape(conf)
    per_frame = run.cell.config["nets"] * flops.forward_flops(
        conf["image_height"], conf["image_width"], conf["kpt_heads"],
        blocks, width)
    frames = run.cell.workload["trace_frames"]
    return 100.0 * per_frame * frames / seconds / flops.H100_BF16_PEAK
