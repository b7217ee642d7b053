"""K1's share of its roofline in a layer-norm training step: the least
time of the endpoint gathers and gate of every layer in each of the two
symmetry passes (width d), over the device time of the kernels named
``k1_gather_gate_kernel``."""
from benchmarks.harness import costs, readers

PATTERN = r"\bk1_gather_gate_kernel\b"


def read(ctx):
    c = ctx.config
    return readers.roofline(ctx, PATTERN, lambda n, e: readers.calls(
        2 * c["num_gnn_layers"], costs.k1_cost(n, e, c["dim_latent"])))
