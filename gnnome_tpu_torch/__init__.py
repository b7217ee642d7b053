"""gnnome_tpu_torch — the genome-assembly GNN pipeline in PyTorch and CUDA.

The PyTorch counterpart of ``gnnome_tpu`` (JAX/Pallas), for NVIDIA Hopper
GPUs.  It imports nothing of ``gnnome_tpu``: host modules are copies, and each
Pallas kernel on the ported path is a hand-written CUDA kernel (``csrc/``)
with a plain PyTorch version beside it (``ops/kernels.py``).  A tensor on the
GPU runs the kernel; a tensor on the CPU runs the plain version.

Sub-packages (names mirror ``gnnome_tpu``)
------------------------------------------
graphs    CPU-side graph containers, the GFA and PAF parsers, ground-truth
          labels, overlap similarity, walk diagnostics, synthetic graphs.
ops       device graph (dst-sorted slots + CSR both ways), the CUDA kernels
          and their plain versions, message-passing ops.
models    SymGatedGCN and the zoo (GatedGCN, GCN, GAT, SAGE) as
          ``nn.Module``s (eval, training, the dual symmetry pass),
          features, weights.
train     training loop, steps, losses, metrics.
decode    greedy path decoding over CSR + assembly FASTA emission.
data      dataset directory layout, the GFA build, read simulation,
          train/valid splits, external-tool installation.
utils     FASTA/Q I/O, seeding, timing.
"""

__version__ = "0.1.0"
