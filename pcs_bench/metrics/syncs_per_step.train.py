"""Host syncs a step: runtime calls in the profiled stretch that make the
host wait for the device (stream, device and event synchronize, blocking
copies), over its steps.  Each drains the launch queue, so the device
idles while the host dispatches what follows."""

UNIT = "syncs/step"
MOVES = "train_points_per_s"
ENTRY = "train_step"


def read(ctx):
    return ctx["trace"]["syncs"] / ctx["traced_units"]
