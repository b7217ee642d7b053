"""Training loop (reference train.py:188-494; JAX ``train/loop.py``).

Same protocol as the JAX package: per epoch, shuffle graphs; per graph, a
random strandwise mask, full-graph or clustered units, the symmetry (or
plain BCE) loss, one Adam step per unit; epoch metrics averaged over units;
validation drives best-model selection, the plateau LR scheduler and
per-epoch resumable checkpoints.  ``overfit`` trains and selects on the
training set (train.py:361-372).

It runs on ``compute.device`` (``cuda`` by default; ``cpu`` runs the
kernels' plain versions).  Dropout masks come from one ``torch.Generator``
on that device, seeded with ``train.seed``.

Logging: JSONL (always) + optional wandb (config ``wandb_mode='online'``).
Checkpoints: flat npz with the model (params/state in the JAX package's
layout), the Adam moments, the scheduler, the epoch and every RNG state
(Python, numpy, the dropout generator), so a resumed run continues exactly
where the uninterrupted one would (the checkpoint is written after the
epoch's scheduler step; the JAX loop writes it before, so its resume skips
one).  The best model is saved as npz in the
JAX layout, which both packages load.
"""
from __future__ import annotations

import json
import os
import random
import time
from datetime import datetime

import numpy as np
import torch

from ..config import Config, resolve_device
from ..data.dataset import dataset_for
from ..models import SymGatedGCN
from ..models.checkpoint import load_pytrees, save_model_weights, save_pytrees
from ..models.convert import module_state_from_numpy, numpy_from_module_state
from ..utils.seed import set_seed
from .metrics import average_epoch_metrics, compute_metrics
from .scheduler import ReduceLROnPlateau
from .step import (eval_step, host_units, make_example, make_optimizer,
                   set_learning_rate, train_step)


def _pos_weight_from(ds) -> float:
    """pos_weight = 1 / mean(pos:neg ratio per graph) (train.py:246,258)."""
    ratios = []
    for _, g in ds:
        pos = float((np.round(g.y) == 1).sum())
        neg = float((np.round(g.y) == 0).sum())
        ratios.append(pos / neg if neg else 1.0)
    mean_ratio = sum(ratios) / len(ratios) if ratios else 1.0
    return 1.0 / mean_ratio if mean_ratio else 1.0


class JsonlLogger:
    def __init__(self, path: str, wandb_mode: str = "disabled",
                 wandb_project: str = "", run_name: str = "", config=None):
        self.f = open(path, "a")
        self.wandb = None
        if wandb_mode == "online":
            try:
                import wandb
                self.wandb = wandb.init(project=wandb_project, name=run_name,
                                        config=config)
            except Exception as e:  # wandb optional (train.py:484-486)
                print(f"wandb unavailable: {e}")

    def log(self, data: dict) -> None:
        self.f.write(json.dumps(data) + "\n")
        self.f.flush()
        if self.wandb is not None:
            try:
                self.wandb.log(data)
            except Exception as e:
                print(f"WandB exception occured! {e}")

    def close(self):
        self.f.close()
        if self.wandb is not None:
            self.wandb.finish()


def _run_epoch(ds, model, opt, pos_weight, cfg, rng_np, generator, device,
               training: bool) -> dict:
    metrics_list = []
    order = list(range(len(ds)))
    if training:
        random.shuffle(order)  # train.py:305
    for i in order:
        _, graph = ds[i]
        for unit in host_units(graph, cfg, rng_np, shuffle_parts=training):
            ex = make_example(unit.in_deg, unit.out_deg, unit.e_feat, unit.y,
                              unit.src, unit.dst, unit.n_nodes, device)
            if training:
                loss, logits = train_step(model, opt, ex, pos_weight, cfg,
                                          generator)
            else:
                loss, logits = eval_step(model, ex, pos_weight, cfg)
            metrics_list.append(compute_metrics(
                logits.cpu().numpy(), ex.labels_host, float(loss)))
    return average_epoch_metrics(metrics_list) if metrics_list else {}


# ------------------------------------------------------------- checkpoints
def _rng_state(rng_np, generator) -> dict:
    """Every RNG the loop draws from, as plain arrays: Python's (shuffles),
    numpy's (masking, clusters) and the dropout generator."""
    version, words, gauss = random.getstate()
    return {"python_version": np.int64(version),
            "python_words": np.asarray(words, dtype=np.int64),
            "python_gauss": np.asarray([] if gauss is None else [gauss],
                                       dtype=np.float64),
            "numpy": np.asarray(json.dumps(rng_np.bit_generator.state)),
            "dropout": generator.get_state().numpy()}


def _set_rng_state(st: dict, rng_np, generator) -> None:
    gauss = st["python_gauss"]
    random.setstate((int(st["python_version"]),
                     tuple(int(w) for w in st["python_words"]),
                     float(gauss[0]) if gauss.size else None))
    rng_np.bit_generator.state = json.loads(str(st["numpy"]))
    generator.set_state(torch.as_tensor(st["dropout"]))


def _save_ckpt(path, epoch, model, opt, scheduler, loss_train, loss_valid,
               rng_np, generator):
    params, state = numpy_from_module_state(model.state_dict())
    moments = {}
    for name, p in model.named_parameters():
        st = opt.state[p]
        moments[name] = {"step": np.float32(float(st["step"])),
                         "exp_avg": st["exp_avg"].cpu().numpy(),
                         "exp_avg_sq": st["exp_avg_sq"].cpu().numpy()}
    meta = {"epoch": np.int64(epoch),
            "loss_train": np.asarray(loss_train or [0.0]),
            "loss_valid": np.asarray(loss_valid or [0.0]),
            "lr": np.float64(scheduler.lr),
            "sched_best": np.float64(scheduler.best),
            "sched_bad": np.int64(scheduler.num_bad_epochs),
            "sched_cooldown": np.int64(scheduler.cooldown_counter)}
    save_pytrees(path, params=params, state=state, opt=moments, meta=meta,
                 rng=_rng_state(rng_np, generator))


def _load_ckpt(path, model, opt, scheduler, rng_np, generator, device):
    """Restores everything ``_save_ckpt`` wrote; returns (start_epoch,
    loss_train, loss_valid)."""
    trees = load_pytrees(path)
    model.load_state_dict(module_state_from_numpy(
        trees["params"], trees["state"], model.normalization))
    for name, p in model.named_parameters():
        st = trees["opt"][name]
        opt.state[p] = {
            "step": torch.tensor(float(st["step"]), dtype=torch.float32),
            "exp_avg": torch.as_tensor(st["exp_avg"], device=device),
            "exp_avg_sq": torch.as_tensor(st["exp_avg_sq"], device=device)}
    meta = trees["meta"]
    scheduler.lr = float(meta["lr"])
    scheduler.best = float(meta["sched_best"])
    scheduler.num_bad_epochs = int(meta["sched_bad"])
    scheduler.cooldown_counter = int(meta["sched_cooldown"])
    _set_rng_state(trees["rng"], rng_np, generator)
    return (int(meta["epoch"]) + 1,
            [float(v) for v in np.atleast_1d(meta["loss_train"])],
            [float(v) for v in np.atleast_1d(meta["loss_valid"])])


def train(train_path: str, valid_path: str, assembler: str,
          out_name: str | None = None, overfit: bool = False,
          resume: bool = False, cfg: Config | None = None) -> str:
    """Train the SymGatedGCN edge scorer; returns the best-model path."""
    cfg = cfg or Config()
    device = resolve_device(cfg.compute.device)
    rng_np, _ = set_seed(cfg.train.seed)
    generator = torch.Generator(device=device).manual_seed(cfg.train.seed)

    timestamp = datetime.now().strftime("%Y-%b-%d-%H-%M-%S")
    out = (out_name or timestamp) + f"_seed{cfg.train.seed}"

    models_path = os.path.abspath(cfg.paths.models_path)
    ckpts_path = os.path.abspath(cfg.paths.checkpoints_path)
    os.makedirs(models_path, exist_ok=True)
    os.makedirs(ckpts_path, exist_ok=True)
    model_path = os.path.join(models_path, f"model_{out}.npz")
    ckpt_path = os.path.join(ckpts_path, f"ckpt_{out}.npz")

    ds_train = dataset_for(assembler, train_path, config=cfg)
    ds_valid = (ds_train if overfit
                else dataset_for(assembler, valid_path, config=cfg))
    if len(ds_train) == 0:
        raise FileNotFoundError(
            f"No processed graphs found under {train_path}/{assembler}/processed")
    if len(ds_valid) == 0:
        raise FileNotFoundError(
            f"No processed graphs found under {valid_path}/{assembler}/processed")

    pos_weight = _pos_weight_from(ds_train)
    model = SymGatedGCN.from_config(cfg.model).init_weights(cfg.train.seed)
    model.to(device)
    opt = make_optimizer(model, cfg.train.lr)
    scheduler = ReduceLROnPlateau(cfg.train.lr, factor=cfg.train.decay,
                                  patience=cfg.train.patience)

    start_epoch = 0
    loss_train_hist: list[float] = []
    loss_valid_hist: list[float] = []
    if resume:
        start_epoch, loss_train_hist, loss_valid_hist = _load_ckpt(
            ckpt_path, model, opt, scheduler, rng_np, generator, device)
        model_path = os.path.join(
            models_path, f"model_{out}_resumed-{cfg.train.num_epochs}.npz")
        ckpt_path = os.path.join(
            ckpts_path, f"ckpt_{out}_resumed-{cfg.train.num_epochs}.npz")
        print(f"Resuming from epoch {start_epoch}")

    print("----- TRAIN CONFIGURATION SUMMARY -----")
    print(f"Using device: {device}")
    print(f"Seed: {cfg.train.seed}  Model path: {model_path}")
    print(f"Trainable parameters: "
          f"{sum(p.numel() for p in model.parameters())}")
    print(f"Normalization: {cfg.model.normalization}  "
          f"pos_weight: {pos_weight:.4f}")
    print("---------------------------------------")

    logger = JsonlLogger(os.path.join(ckpts_path, f"log_{out}.jsonl"),
                         cfg.wandb_mode, cfg.wandb_project, out, cfg.to_dict())

    def save_best():
        save_model_weights(model_path,
                           *numpy_from_module_state(model.state_dict()))

    def save_ckpt(epoch):
        _save_ckpt(ckpt_path, epoch, model, opt, scheduler, loss_train_hist,
                   loss_valid_hist, rng_np, generator)

    try:
        for epoch in range(start_epoch, cfg.train.num_epochs):
            t0 = time.time()
            set_learning_rate(opt, scheduler.lr)
            m_train = _run_epoch(ds_train, model, opt, pos_weight, cfg,
                                 rng_np, generator, device, training=True)
            loss_train_hist.append(m_train["loss"])

            log = {f"train/{k}": v for k, v in m_train.items()}
            log["lr_value"] = scheduler.lr
            log["epoch"] = epoch
            log["train_epoch_wall_s"] = round(time.time() - t0, 2)

            if overfit:
                # select on train loss; no validation (train.py:361-372)
                if len(loss_train_hist) == 1 or \
                        loss_train_hist[-1] < min(loss_train_hist[:-1]):
                    save_best()
                    print(f"Epoch {epoch}: model saved (overfit) "
                          f"train_loss={m_train['loss']:.6f} "
                          f"f1={m_train['f1']:.4f}")
                scheduler.step(m_train["loss"])
                save_ckpt(epoch)
                logger.log(log)
                print(f"Epoch {epoch} ({time.time()-t0:.1f}s): "
                      f"train loss {m_train['loss']:.6f}")
                continue

            m_valid = _run_epoch(ds_valid, model, opt, pos_weight, cfg,
                                 rng_np, generator, device, training=False)
            loss_valid_hist.append(m_valid["loss"])
            log.update({f"valid/{k}": v for k, v in m_valid.items()})
            log["epoch_wall_s"] = round(time.time() - t0, 2)

            if len(loss_valid_hist) == 1 or \
                    loss_valid_hist[-1] < min(loss_valid_hist[:-1]):
                save_best()
                print(f"Epoch {epoch}: model saved! valid_loss="
                      f"{m_valid['loss']:.6f} f1={m_valid['f1']:.4f}")
            scheduler.step(m_valid["loss"])
            save_ckpt(epoch)
            logger.log(log)
            print(f"Epoch {epoch} ({time.time()-t0:.1f}s): "
                  f"train {m_train['loss']:.6f} valid {m_valid['loss']:.6f} "
                  f"lr {scheduler.lr:.2e}")
    except KeyboardInterrupt:
        print("Keyboard Interrupt... Exiting...")
    finally:
        logger.close()

    return model_path
