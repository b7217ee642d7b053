"""gnnome_tpu_torch — the genome-assembly GNN pipeline in PyTorch and CUDA.

The PyTorch counterpart of ``gnnome_tpu`` (JAX/Pallas), for NVIDIA Hopper
GPUs.  It imports nothing of ``gnnome_tpu``: host modules are copies, and each
Pallas kernel on the ported path is a hand-written CUDA kernel (``csrc/``)
with a plain PyTorch version beside it (``ops/kernels.py``).  A tensor on the
GPU runs the kernel; a tensor on the CPU runs the plain version.

Sub-packages (names mirror ``gnnome_tpu``)
------------------------------------------
graphs    CPU-side graph containers, ground-truth labels, overlap similarity,
          synthetic graphs.
ops       device graph (dst-sorted slots + CSR both ways), K3/K6 kernels and
          their plain versions, message-passing ops.
models    SymGatedGCN as an ``nn.Module`` (eval forward), features, weights.
decode    greedy path decoding over CSR + assembly FASTA emission.
data      dataset directory layout.
utils     FASTA/Q I/O, seeding, timing.
"""

__version__ = "0.1.0"
