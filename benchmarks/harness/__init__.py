"""The benchmark's yardstick: the manifest and the files it names, the
traffic's graphs, the weights, the peaks and costs, the profiler's
reduction, the comparison that decides ``correct``, and one run of a
cell."""
