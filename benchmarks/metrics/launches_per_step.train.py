"""Device operations launched per training step in the traced segment."""
from benchmarks.harness import readers


def read(ctx):
    return readers.launches_per_unit(ctx)
