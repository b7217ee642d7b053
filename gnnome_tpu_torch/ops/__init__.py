from .graph_tensors import DeviceGraph  # noqa: F401
from .message import (aggregate, eval_edge_stage, gate_gather,  # noqa: F401
                      gated_mean_pair, gather_rows, gather_uv, score_gate,
                      sum_into, train_edge_stage, unfused_edge_stage)
