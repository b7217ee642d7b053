from .sym_gated_gcn import SymGatedGCN  # noqa: F401
from .zoo import GAT, GCN, SAGE, GatedGCN, get_model  # noqa: F401
from .convert import (load_model_pytrees, module_state_from_numpy,  # noqa: F401
                      numpy_from_module_state, pytrees_from_model)
from .checkpoint import load_model_weights  # noqa: F401
from .features import edge_features, node_features  # noqa: F401
