"""K1's share of its roofline over the pass traced for device activity
alone, in percent: the least time the vote-count kernel could take for
the pairs that count, over its device time. A pair is a (voxel, voting
point); the hier vote counts (grid / 4)^3 cells over every
``vote_cpt_stride``-th point, then ``vote_topk`` x ``vote_win``^3 voxels
over every point, and only points that vote count (the padding to
``max_points`` does not). Each pair needs 11 instructions (3 sub, 3 mul,
2 add, 2 compares, the count add); none is an FMA, so the bound is the
issue rate: 132 SMs x 4 sub-partitions x 32 lanes x 1.98 GHz. Both
numbers are frozen here, so a kernel that does the same work in fewer
instructions reads higher."""

from perfbench.harness import serving, trace

INSTRUCTIONS_PER_PAIR = 11
ISSUE_RATE = 132 * 4 * 32 * 1.98e9
KERNEL = "vote_counts_kernel"


def read(run):
    points = run.counters.get("vote_points")
    if not run.device_events or not points:
        return None
    k1 = [e for e in trace.in_window(run.device_events)
          if e.kind == "device" and KERNEL in e.name]
    if not k1:
        return None
    conf = serving.settings(run)
    coarse_pts, fine_pts = points
    pairs = ((conf["vote_grid_l"] // 4) ** 3 * coarse_pts
             + conf["vote_topk"] * conf["vote_win"] ** 3 * fine_pts)
    bound_s = pairs * INSTRUCTIONS_PER_PAIR / ISSUE_RATE
    return 100.0 * bound_s / (trace.total_ns(k1) / 1e9)
