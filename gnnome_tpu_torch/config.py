"""Typed configuration for gnnome_tpu_torch.

The same sections, fields and defaults as ``gnnome_tpu/config.py`` (defaults
reproduce the reference's shipped values, reference
configs/hyperparameters.py:3-52, configs/config.py:1-14), so ``--set
section.key=value`` overrides carry over between the two packages.  The one
difference is ``ComputeConfig``: it holds only ``device`` (``cuda`` | ``cpu``).
The JAX package's backend, mesh, padding, bucket, remat, scheduler, dtype and
buffer-donation knobs have no meaning here (the tensor's device chooses
kernel or plain version; edges are never padded; the forward runs in f32)
and are rejected with a message when set.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field


@dataclass
class ModelConfig:
    """Model hyperparameters (reference configs/hyperparameters.py:20-29)."""
    model: str = "sym_gatedgcn"       # sym_gatedgcn | gatedgcn | gcn | gat | sage
    dim_latent: int = 64
    num_gnn_layers: int = 8
    node_features: int = 2
    edge_features: int = 2            # 2 with overlap similarity, 1 without
    hidden_ne_features: int = 16
    hidden_edge_scores: int = 64
    normalization: str = "batch"      # batch | layer | none
    dropout: float = 0.2
    directed: bool = True             # zoo variants only (reference models/full_graph.py:34)
    gat_num_heads: int = 3            # reference layers/processor.py:49


@dataclass
class DataConfig:
    """Featurization + data generation (reference configs/hyperparameters.py:17, config.py:12-13)."""
    use_similarities: bool = True
    sequencing_depth: int = 60
    sample_profile_id: str = "20kb-m64011_190830_220126"
    sample_file: str = ""


@dataclass
class TrainConfig:
    """Training knobs (reference configs/hyperparameters.py:32-42)."""
    num_epochs: int = 5
    lr: float = 1e-4
    use_symmetry_loss: bool = True
    alpha: float = 0.1                 # symmetry-loss weight
    num_nodes_per_cluster: int = 1000  # partition graphs larger than this
    k_extra_hops: int = 1              # halo size for cluster training
    patience: int = 2                  # plateau-scheduler patience
    decay: float = 0.95                # plateau-scheduler factor
    masking: bool = True
    mask_frac_low: int = 80            # % of nodes kept (low end)
    mask_frac_high: int = 100
    seed: int = 1
    device: str = "cuda"


@dataclass
class DecodeConfig:
    """Greedy decoding (reference configs/hyperparameters.py:45-51, inference.py:25-28)."""
    strategy: str = "greedy"
    num_decoding_paths: int = 100
    decode_with_labels: bool = False
    load_checkpoint: bool = True
    num_threads: int = 32
    len_threshold: int = 70_000
    random_baseline: bool = False      # reference inference.py RANDOM flag
    early_stopping: bool = False       # reference inference.py early_stopping flag
    p_threshold: float = 0.06


@dataclass
class PathsConfig:
    """Tool/asset locations (reference configs/config.py:1-14)."""
    checkpoints_path: str = "checkpoints"
    models_path: str = "checkpoints"
    tool_dir: str = "vendor"
    raven_dir: str = "vendor/raven-1.8.1"
    hifiasm_dir: str = "vendor/hifiasm-0.18.8"
    pbsim3_dir: str = "vendor/pbsim3"
    minigraph: str = "minigraph"       # configurable (reference hardcodes user paths, utils/evaluate.py:140)
    paftools: str = "paftools.js"


@dataclass
class ComputeConfig:
    """Where the model runs.  ``cuda`` launches the hand-written kernels and
    raises when no GPU is present; ``cpu`` runs their plain PyTorch
    versions.  There is no silent fallback from one to the other."""
    device: str = "cuda"               # cuda | cuda:N | cpu


# JAX-package compute knobs that the port does not carry, with the reason
_DROPPED_COMPUTE = {
    "backend": "the tensor's device chooses kernel (cuda) or plain version (cpu)",
    "mesh": "multi-GPU inference is not ported yet",
    "dtype": "the port runs in float32; bfloat16 is not ported yet",
    "matmul_precision": "matmuls run in full float32 (TF32 disabled)",
    "edge_pad_multiple": "edges are never padded",
    "node_pad_multiple": "nodes are never padded",
    "bucket_growth": "no shape buckets: PyTorch runs eagerly",
    "remat": "training is not ported yet",
    "scheduler": "an XLA option with no PyTorch counterpart",
    "donate_state": "an XLA option with no PyTorch counterpart",
}


def resolve_device(name: str):
    """``torch.device`` for ``compute.device``.  Raises when CUDA is asked
    for and absent — never falls back to the CPU.  Disables TF32 for
    matmuls and cuDNN so float32 stays float32 on the card."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"compute.device={name!r} but no CUDA device is available; "
                "pass --set compute.device=cpu to run on the CPU")
    elif dev.type != "cpu":
        raise ValueError(f"compute.device must be cuda|cuda:N|cpu, got {name!r}")
    return dev


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    decode: DecodeConfig = field(default_factory=DecodeConfig)
    paths: PathsConfig = field(default_factory=PathsConfig)
    compute: ComputeConfig = field(default_factory=ComputeConfig)
    wandb_mode: str = "disabled"
    wandb_project: str = "gnnome-tpu"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        cfg = cls()
        for section, values in d.items():
            if not hasattr(cfg, section):
                raise KeyError(f"Unknown config section: {section}")
            cur = getattr(cfg, section)
            if dataclasses.is_dataclass(cur) and isinstance(values, dict):
                for k, v in values.items():
                    if not hasattr(cur, k):
                        raise KeyError(f"Unknown config key: {section}.{k}")
                    setattr(cur, k, v)
            else:
                setattr(cfg, section, values)
        return cfg

    @classmethod
    def load(cls, path: str) -> "Config":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)

    def apply_overrides(self, overrides: list[str]) -> "Config":
        """Apply ``section.key=value`` CLI overrides (highest precedence,
        mirroring the reference's CLI-arg > dict precedence, train.py:243-244)."""
        for ov in overrides:
            key, _, raw = ov.partition("=")
            section, _, attr = key.partition(".")
            if not attr:
                raise KeyError(f"Override must be section.key=value: {ov}")
            if not hasattr(self, section):
                raise KeyError(
                    f"Unknown config section '{section}' in --set {ov}; "
                    f"sections: {[f.name for f in dataclasses.fields(self)]}")
            target = getattr(self, section)
            if section == "compute" and attr in _DROPPED_COMPUTE:
                raise AttributeError(
                    f"--set {ov}: compute.{attr} is a gnnome_tpu option that "
                    f"gnnome_tpu_torch does not have ({_DROPPED_COMPUTE[attr]})")
            if not hasattr(target, attr):
                raise AttributeError(
                    f"Unknown config key '{section}.{attr}' in --set {ov}; "
                    f"keys: {[f.name for f in dataclasses.fields(target)]}")
            old = getattr(target, attr)
            if isinstance(old, bool):
                if raw.lower() in ("1", "true", "yes"):
                    val = True
                elif raw.lower() in ("0", "false", "no"):
                    val = False
                else:
                    raise ValueError(f"--set {ov}: expected a boolean")
            elif isinstance(old, int):
                val = int(raw)
            elif isinstance(old, float):
                val = float(raw)
            else:
                val = raw
            setattr(target, attr, val)
        return self


def get_config() -> Config:
    return Config()
