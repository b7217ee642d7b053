from .sym_gated_gcn import SymGatedGCN  # noqa: F401
from .convert import module_state_from_numpy, numpy_from_module_state  # noqa: F401
from .checkpoint import load_model_weights  # noqa: F401
from .features import edge_features, node_features  # noqa: F401
