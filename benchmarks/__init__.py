"""The benchmark of ``gnnome_tpu_torch`` on the card: ``run.py`` runs one
cell of ``BENCHMARK.json``; ``calibrate.py`` reads the numbers that the
check of ``correct`` compares, over many seeds, for the program and its
controls."""
