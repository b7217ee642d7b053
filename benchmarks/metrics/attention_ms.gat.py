"""Device time of the GAT layers' attention in the forward (the program's
spans ``gat.attention``: ``el``/``er``, the edge logits, the segment max,
``exp``, the denominators and ``alpha``) per traced training step."""
from benchmarks.harness import spans


def read(ctx):
    return spans.per_unit_ms(ctx, "gat.attention")
