"""Device time of the GAT layers' messages in the forward (the program's
spans ``gat.aggregate``: the [E', H d] gather, the weighting by ``alpha``,
the sum into nodes and the bias) per traced training step."""
from benchmarks.harness import spans


def read(ctx):
    return spans.per_unit_ms(ctx, "gat.aggregate")
