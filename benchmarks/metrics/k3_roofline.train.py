"""K3's share of its roofline in a batch-norm training step: the least
time of the edge stage of every layer over both symmetry passes at once
(width 2d: one dual-width pass reads the shared indices once), over the
device time of the kernels named ``k3_pass_*``."""
from benchmarks.harness import costs, readers

PATTERN = r"\bk3_pass_[uv]\b"


def read(ctx):
    c = ctx.config
    return readers.roofline(ctx, PATTERN, lambda n, e: readers.calls(
        c["num_gnn_layers"], costs.k3_cost(n, e, 2 * c["dim_latent"])))
