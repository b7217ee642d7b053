"""The whole scoring request's share of the card's float32 peak: the
matrix products of one eval forward (``costs.request_flops``) summed over
the window's requests, over the window's seconds."""
from benchmarks.harness import costs, readers


def read(ctx):
    return readers.mfu(ctx, costs.request_flops)
