"""Device time of the forward pass(es) and the loss (the program's span
``train.forward``) per traced training step."""
from benchmarks.harness import spans


def read(ctx):
    return spans.per_unit_ms(ctx, "train.forward")
