"""Host syncs a block: runtime calls in the profiled stretch that make the
host wait for the device (stream, device and event synchronize, blocking
copies), over its blocks.  Each drains the launch queue, so the device
idles while the host dispatches what follows."""

UNIT = "syncs/block"
MOVES = "label_points_per_s"
ENTRY = "scene_probs"


def read(ctx):
    return ctx["trace"]["syncs"] / ctx["traced_blocks"]
