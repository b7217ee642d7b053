"""The share of a traced scoring segment in which no operation ran on
the device."""
from benchmarks.harness import readers


def read(ctx):
    return readers.idle_share(ctx)
