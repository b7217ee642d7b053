"""The benchmark's CPU tests import ``benchmarks`` from the repository's
root and keep PyTorch to a few threads, so that several test workers do
not crowd one machine's cores."""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

torch.set_num_threads(2)
