"""Typed configuration for gnnome_tpu_torch.

The same sections, fields and defaults as ``gnnome_tpu/config.py`` (defaults
reproduce the reference's shipped values, reference
configs/hyperparameters.py:3-52, configs/config.py:1-14), so ``--set
section.key=value`` overrides carry over between the two packages.  The one
difference is ``ComputeConfig``: it holds only ``device`` (``cuda`` | ``cpu``),
``dtype`` (``float32`` | ``bfloat16``, the JAX package's compute dtype,
for the SymGatedGCN at every normalisation) and ``mesh`` (the JAX
package's: 0 or 1 runs on one device, P > 1 shards each graph over P ranks
of ``torch.distributed`` through ``parallel/halo.py``, for the batch-norm
SymGatedGCN only).  The JAX package's backend, matmul-precision, padding,
bucket, remat, scheduler and buffer-donation knobs have no meaning here
(the tensor's device chooses
kernel or plain version; edges are never padded; float32 matmuls run in
full float32, bf16 ones take bf16 operands): ``--set`` rejects them with a
message, and ``--config`` reads a file that the JAX package wrote, skipping
the values the port honours anyway and rejecting the others with the reason
(``Config.from_dict``).
"""
from __future__ import annotations

import dataclasses
import json
import re
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
    """Where and in what the model runs.  ``cuda`` launches the hand-written
    kernels and raises when no GPU is present; ``cpu`` runs their plain
    PyTorch versions.  There is no silent fallback from one to the other.
    ``dtype`` is the GNN's compute dtype (JAX ``compute.dtype``):
    ``bfloat16`` runs the SymGatedGCN's gathers, matmuls, gates and kernels
    in bf16 with float32 node sums (and float32 BatchNorm; LayerNorm
    promotes to float32, as in JAX); the zoo ignores it, as in JAX.
    ``mesh`` > 1 shards each graph over that many ranks (processes of one
    ``torch.distributed`` group, ``parallel/group.py``): NCCL with one GPU
    per rank where the machine has enough GPUs, else gloo (CPU ranks, or
    ranks sharing one card, their strips staged through host memory)."""
    device: str = "cuda"               # cuda | cuda:N | cpu
    dtype: str = "float32"             # float32 | bfloat16
    mesh: int = 0                      # >1: shard each graph over N ranks


# JAX-package compute knobs that the port does not carry, with the reason
_DROPPED_COMPUTE = {
    "backend": "the tensor's device chooses kernel (cuda) or plain version (cpu)",
    "matmul_precision": "matmuls run in full float32 (TF32 disabled), or "
                        "on bf16 operands with compute.dtype=bfloat16",
    "edge_pad_multiple": "edges are never padded",
    "node_pad_multiple": "nodes are never padded",
    "bucket_growth": "no shape buckets: PyTorch runs eagerly",
    "remat": "the training edge stage keeps only small residuals and "
             "recomputes its projections; there is nothing to rematerialise",
    "scheduler": "an XLA option with no PyTorch counterpart",
    "donate_state": "an XLA option with no PyTorch counterpart",
}


# Of those, the values the port honours as it is (a config file written by
# gnnome_tpu may carry them); a key not listed here takes any value.
# matmul_precision=default (bf16-accelerated matmuls) only together with
# dtype=bfloat16: with bf16 operands TF32 does not apply (Config.from_dict).
_HONOURED_COMPUTE = {
    "matmul_precision": (("highest", "default"),
                         "compute.matmul_precision=highest"),
}
DTYPES = ("float32", "bfloat16")


def check_compute(cfg: "Config", command: str | None = None) -> None:
    """Raise for a compute dtype the port does not run (one outside
    ``DTYPES``; every normalisation runs both) and for a ``compute.mesh``
    that is not a rank count.  With ``command`` ``train`` (the entry that
    is about to run) also for ``compute.mesh > 1`` with a model the halo
    path does not train: it trains the batch-norm SymGatedGCN only (JAX
    ``halo_supported``, parallel/halo.py:477-481), and the JAX package
    trains the others on one device (train/loop.py:143-158,222-223), as
    ``compute.mesh=0`` does here.  ``infer`` runs every model at
    ``mesh > 1``: the others' eval forward on the sharded path
    (``parallel/sharded.py``, JAX's GSPMD path, infer.py:65-77).  No
    ``mesh > 1`` path runs quietly on one device."""
    dt = cfg.compute.dtype
    if dt not in DTYPES:
        raise ValueError(f"compute.dtype={dt!r}: the port runs "
                         "float32|bfloat16; use compute.dtype=float32 or "
                         "compute.dtype=bfloat16")
    mesh = cfg.compute.mesh
    if not isinstance(mesh, int) or isinstance(mesh, bool) or mesh < 0:
        raise ValueError(f"compute.mesh={mesh!r}: expected 0, 1 (one "
                         "device) or the number of ranks")
    if command != "train" or mesh <= 1:
        return
    from .parallel.halo import halo_supported
    if halo_supported(cfg.model):
        return
    raise ValueError(
        f"compute.mesh={mesh} trains the batch-norm SymGatedGCN only "
        f"(model.model={cfg.model.model!r}, model.normalization="
        f"{cfg.model.normalization!r}): the halo path shards that model; "
        "the JAX package trains this config on one device; use "
        "compute.mesh=0 for the same run")


def compute_dtype(cfg: "Config"):
    """The ``torch.dtype`` of ``cfg.compute.dtype`` (checked first)."""
    import torch

    check_compute(cfg)
    return torch.bfloat16 if cfg.compute.dtype == "bfloat16" else torch.float32


def _check_device_name(name: str) -> None:
    if not isinstance(name, str) or not re.fullmatch(r"cuda(:\d+)?|cpu", name):
        raise ValueError(f"compute.device must be cuda|cuda:N|cpu, got {name!r}")


def resolve_device(name: str):
    """``torch.device`` for ``compute.device``.  Raises when CUDA is asked
    for and absent — never falls back to the CPU.  Disables TF32 for
    matmuls and cuDNN so float32 stays float32 on the card, and the bf16
    reduction of bf16 GEMM partials, so bf16 products accumulate in float32
    as XLA's bf16 dots do."""
    import torch

    _check_device_name(name)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"compute.device={name!r} but no CUDA device is available; "
            "pass --set compute.device=cpu to run on the CPU")
    return dev


def _compute_from_file(key: str, value):
    """A ``compute`` entry of a config file, which gnnome_tpu may have
    written: ``(key, value)`` to set, or None for a gnnome_tpu knob whose
    value the port honours anyway.  Raises for a value it cannot honour."""
    if key == "device":
        value = "cuda" if value == "auto" else value     # gnnome_tpu's default
        _check_device_name(value)
        return key, value
    if key not in _DROPPED_COMPUTE:
        return key, value
    ok, works = _HONOURED_COMPUTE.get(key, (None, None))
    if ok is not None and value not in ok:
        raise ValueError(
            f"config file: compute.{key}={value!r} cannot be honoured by "
            f"gnnome_tpu_torch ({_DROPPED_COMPUTE[key]}); use {works} or "
            f"leave the key out")
    return None


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
        """From a dict such as ``Config.load`` reads: this package's
        ``to_dict`` or a config file that ``gnnome_tpu.config.Config.save``
        wrote.  Of the latter's compute knobs, those whose values the port
        honours anyway (highest precision, default precision with bfloat16,
        and any backend, padding, bucket, remat, scheduler or donation
        setting) are skipped; any other value raises with the reason.
        ``compute.device`` ``auto`` (gnnome_tpu's default) means ``cuda``;
        ``compute.dtype`` and ``compute.mesh`` are read
        (``check_compute``)."""
        cfg = cls()
        precision = None
        for section, values in d.items():
            if not hasattr(cfg, section):
                raise KeyError(f"Unknown config section: {section}")
            cur = getattr(cfg, section)
            if dataclasses.is_dataclass(cur) and isinstance(values, dict):
                for k, v in values.items():
                    if section == "compute":
                        if k == "matmul_precision":
                            precision = v
                        kv = _compute_from_file(k, v)
                        if kv is None:
                            continue
                        k, v = kv
                    if not hasattr(cur, k):
                        raise KeyError(f"Unknown config key: {section}.{k}")
                    setattr(cur, k, v)
            else:
                setattr(cfg, section, values)
        if precision == "default" and cfg.compute.dtype != "bfloat16":
            raise ValueError(
                "config file: compute.matmul_precision='default' cannot be "
                "honoured by gnnome_tpu_torch with compute.dtype="
                f"{cfg.compute.dtype!r} ({_DROPPED_COMPUTE['matmul_precision']}"
                "); use compute.matmul_precision=highest or "
                "compute.dtype=bfloat16")
        check_compute(cfg)
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
        check_compute(self)
        return self


def get_config() -> Config:
    return Config()
