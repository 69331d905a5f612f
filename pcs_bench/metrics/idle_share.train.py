"""The device's idle share of the profiled stretch: one minus the union of
its kernel, copy and set intervals over the stretch's length."""

UNIT = "%"
MOVES = "train_points_per_s"
ENTRY = "train_step"


def read(ctx):
    t = ctx["trace"]
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
