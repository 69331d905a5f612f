"""The whole label work's share of the card's dense bf16 peak: the blocks
of the unprofiled window times the operations of one block (counted on the
reference from the configuration's shapes, counts/work.py) over the
window's seconds and the peak."""

UNIT = "%"
MOVES = "label_points_per_s"
ENTRY = "scene_probs"


def read(ctx):
    flops = ctx["work"]["flops"] * ctx["window_blocks"]
    return 100.0 * flops / ctx["window_s"] / ctx["peaks"]["bf16_flops"]
