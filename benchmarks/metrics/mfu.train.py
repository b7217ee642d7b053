"""The whole training step's share of the card's float32 peak: the
matrix products a symmetry-loss step needs (``costs.step_flops``) times
the window's steps, over the window's seconds."""
from benchmarks.harness import costs, readers


def read(ctx):
    return readers.mfu(ctx, costs.step_flops)
