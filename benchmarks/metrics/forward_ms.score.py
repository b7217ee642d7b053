"""Device time of the model's eval forward (the program's span
``model.forward``) per traced scoring request."""
from benchmarks.harness import spans


def read(ctx):
    return spans.per_unit_ms(ctx, "model.forward")
