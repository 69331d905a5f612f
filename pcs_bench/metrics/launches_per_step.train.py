"""Kernel launches a step (runtime launch calls in the profiled stretch
over its steps): the host's dispatch work, which paces the step where
the device waits on it."""

UNIT = "launches/step"
MOVES = "train_points_per_s"
ENTRY = "train_step"


def read(ctx):
    return ctx["trace"]["launches"] / ctx["traced_units"]
