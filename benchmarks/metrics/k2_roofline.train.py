"""K2's share of its roofline in a layer-norm training step: in each of
the two symmetry passes, the least time of every layer's two-sided sums
into nodes (the gated means' payloads, 2d wide, forward, and the adjoint
of the endpoint gathers, 2d wide, backward) and of the score predictor's
gather adjoint (d wide), over the device time of the kernels named
``csr_row_sum``."""
from benchmarks.harness import costs, readers

PATTERN = r"\bcsr_row_sum\b"


def read(ctx):
    c = ctx.config
    d, layers = c["dim_latent"], c["num_gnn_layers"]
    return readers.roofline(ctx, PATTERN, lambda n, e: 2 * (
        readers.calls(2 * layers, costs.k2_cost(n, e, 2 * d))
        + readers.calls(1, costs.k2_cost(n, e, d))))
