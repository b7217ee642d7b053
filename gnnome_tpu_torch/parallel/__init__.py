"""Graph parallelism: one graph over the ranks of a ``torch.distributed``
group (``group``), by halo exchange (``halo``: the batch-norm
SymGatedGCN) and on the same layout for every other model's eval forward
(``sharded``)."""
from .group import Group, spawn  # noqa: F401
