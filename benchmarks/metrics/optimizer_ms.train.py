"""Device time of the Adam update (the program's span
``train.optimizer``) per traced training step."""
from benchmarks.harness import spans


def read(ctx):
    return spans.per_unit_ms(ctx, "train.optimizer")
