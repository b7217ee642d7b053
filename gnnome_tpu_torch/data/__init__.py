from .dataset import AssemblyGraphDataset, AssemblyGraphDatasetHiFi, AssemblyGraphDatasetONT, dataset_for  # noqa: F401
