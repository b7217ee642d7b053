"""Training of the SymGatedGCN edge scorer (``cli train``)."""
