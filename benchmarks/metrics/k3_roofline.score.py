"""K3's share of its roofline in an eval scoring request: the least time
of the edge stage of every layer of one pass (width d), summed over the
traced requests' graphs, over the device time of the kernels named
``k3_pass_*``."""
from benchmarks.harness import costs, readers

PATTERN = r"\bk3_pass_[uv]\b"


def read(ctx):
    c = ctx.config
    return readers.roofline(ctx, PATTERN, lambda n, e: readers.calls(
        c["num_gnn_layers"], costs.k3_cost(n, e, c["dim_latent"])))
