"""The windowed slab gather (K2) and slab-gradient kernels' (K3: map and
sum) share of their byte bound: the bytes of the profiled stretch's calls
(counted from the configuration's shapes, counts/work.py, each input
byte read once and each output byte written once) at the card's HBM rate,
over the device time the profiler gives those kernels.  Nothing to read
where no such kernel ran."""

UNIT = "%"
MOVES = "label_points_per_s"
ENTRY = "scene_probs"
KERNELS = ("window_gather_kernel", "window_dslab_map_kernel",
           "window_dslab_sum_kernel")


def read(ctx):
    seconds = sum(s for name, s in ctx["trace"]["kernel_s"].items()
                  if any(k in name for k in KERNELS))
    if seconds <= 0.0:
        return None
    nbytes = ctx["work"]["gather_bytes"] * ctx["traced_blocks"]
    return 100.0 * nbytes / ctx["peaks"]["hbm_bytes_per_s"] / seconds
