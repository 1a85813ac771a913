"""Frames completed over the whole window, per second of it."""


def read(run):
    w = run.window
    return w["frames"] / w["seconds"] if w.get("frames") else None
