"""Kernel launches a block (runtime launch calls in the profiled stretch
over its blocks): the host's dispatch work, which paces the block where
the device waits on it."""

UNIT = "launches/block"
MOVES = "label_points_per_s"
ENTRY = "scene_probs"


def read(ctx):
    return ctx["trace"]["launches"] / ctx["traced_blocks"]
