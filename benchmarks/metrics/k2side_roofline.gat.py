"""The K2 walks' share of their roofline in a GAT training step: the least
time of every ``csr_row_sum`` launch a step makes, over their device time.

A layer walks the processor graph's E' slots (the edges and a self-loop a
node) six times: forward, the softmax's denominators (H wide) and the
messages (H d wide) into dst; backward, the adjoints of the row gathers
of ``el`` (H wide, into src), of ``er`` and of the denominators (H wide,
into dst, twice) and of the messages' ``feat`` rows (H d wide, into src).
The score predictor's gather adjoint is one two-sided K2 (d wide, two
launches) over the graph's E edges.  The reader reads nothing unless the
trace holds exactly that many launches a step (6 a layer and 2: the
port's counters count 48 ``k2_side_sum`` calls and one ``k2_aggregate``
call a step): other work under the name would be timed against a bound
that leaves it out."""
from benchmarks.harness import costs, gat_costs, readers

PATTERN = r"\bcsr_row_sum\b"


def read(ctx):
    c = ctx.config
    heads, wide, layers = c["heads"], c["heads"] * c["dim_latent"], \
        c["num_gnn_layers"]
    tr = ctx.device_trace()
    if tr is None or tr.kernel_seconds(PATTERN)[1] != len(
            ctx.traced_units) * (6 * layers + 2):
        return None

    def least(n, e):
        ep = e + n                  # directed: the edges, a self-loop a node

        def walk(width, perm):
            return readers.calls(1, gat_costs.k2_side_cost(n, ep, width,
                                                           perm))

        layer = (3 * walk(heads, False) + walk(wide, False)
                 + walk(heads, True) + walk(wide, True))
        return layers * layer + readers.calls(1, costs.k2_cost(
            n, e, c["dim_latent"]))

    return readers.roofline(ctx, PATTERN, least)
