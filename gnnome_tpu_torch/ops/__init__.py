from .graph_tensors import DeviceGraph  # noqa: F401
from .message import eval_edge_stage, score_gate  # noqa: F401
