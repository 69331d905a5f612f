"""Device time a block under the port's ``pcs.search`` span (each stage's
neighbourhood search: selection, the K2 geometry read, compaction, the
overflow pool): the union of device intervals whose launching call ran
inside the span, over the traced stretch's blocks (``spans.attribute``).
Busy time follows the launching call's host clock, so it holds where the
device clock drifts.  Nothing to read without device events or without
the span."""
from pcs_bench import spans

UNIT = "ms/block"
MOVES = "train_points_per_s"
ENTRY = "train_step"


def read(ctx):
    return spans.read("search_ms_per_block", ctx["spans"],
                      ctx["traced_blocks"])
