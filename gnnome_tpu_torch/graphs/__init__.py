from .container import AssemblyGraph, ReadStore  # noqa: F401
from .gfa import parse_gfa  # noqa: F401
from .labels import compute_gt_labels  # noqa: F401
from .synthetic import synthetic_assembly_graph, simulate_reads_from_genome, random_genome  # noqa: F401
