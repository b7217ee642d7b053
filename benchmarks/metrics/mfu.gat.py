"""The whole GAT training step's share of the card's float32 peak: the
matrix products a step needs (``gat_costs.gat_step_flops``) times the
window's steps, over the window's seconds."""
from benchmarks.harness import gat_costs, readers


def read(ctx):
    return readers.mfu(ctx, gat_costs.gat_step_flops)
