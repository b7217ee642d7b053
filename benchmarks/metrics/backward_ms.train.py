"""Device time of the backward pass (the program's span
``train.backward``) per traced training step."""
from benchmarks.harness import spans


def read(ctx):
    return spans.per_unit_ms(ctx, "train.backward")
