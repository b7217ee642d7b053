"""K8's share of its roofline in a batch-norm training step: the least
time of the edge stage's adjoint of every layer over both symmetry passes
at once (width 2d), over the device time of the kernels named
``k8_pass_*`` and of ``reduce_partials``, which finishes K8's float64
sums."""
from benchmarks.harness import costs, readers

PATTERN = r"\bk8_pass_[uv]\b|\breduce_partials\b"


def read(ctx):
    c = ctx.config
    return readers.roofline(ctx, PATTERN, lambda n, e: readers.calls(
        c["num_gnn_layers"], costs.k8_cost(n, e, 2 * c["dim_latent"])))
