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

With ``compute.mesh = P > 1`` (the batch-norm SymGatedGCN only; JAX
``_HaloRunner``, train/loop.py:77-115,221-232) ``train`` started outside a
group spawns P ranks (``parallel.group.run``) and returns rank 0's
result; in a process a launcher started (a launcher per host,
``compute.mesh`` its ``WORLD_SIZE``) it joins the launcher's group.
Every rank builds the same host units from the same seeds and trains on
its shard of each (``parallel/halo.py``): the gradients are summed over
ranks and every rank steps the same Adam, so the parameters stay equal.
Rank 0 alone gathers the logits for the metrics and writes the log, the
checkpoints and the best model; on ``resume`` rank 0 alone reads the
checkpoint, which holds each rank's dropout generator state, and sends
it to the others, and the run's name is rank 0's (the hosts' disks and
clocks may differ).  Each
epoch's log line adds the halo routes its units took (``halo_routes``)
and every rank's kernel launches in the epoch (``halo_launches``).
"""
from __future__ import annotations

import json
import os
import random
import time
from datetime import datetime

import numpy as np
import torch

from ..config import Config, check_compute, resolve_device
from ..data.dataset import dataset_for
from ..models.checkpoint import load_pytrees, save_model_weights, save_pytrees
from ..models.convert import load_model_pytrees, pytrees_from_model
from ..models.zoo import get_model
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


class _HaloRunner:
    """One rank's unit execution over its group (JAX ``_HaloRunner``):
    its shard of each unit, the halo train or eval step, and on rank 0 the
    unit's logits gathered in host edge order."""

    def __init__(self, group):
        self.group = group
        self.routes: dict = {}

    def run_unit(self, unit, model, opt, pos_weight, cfg, generator,
                 training: bool) -> dict:
        from ..parallel.halo import (gather_edges, halo_eval_step,
                                     halo_example_from_unit, halo_train_step)
        sh = halo_example_from_unit(unit, self.group, self.group.device)
        route = sh.plan.route
        self.routes[route] = self.routes.get(route, 0) + 1
        if training:
            loss, lo = halo_train_step(model, opt, sh, self.group,
                                       pos_weight, cfg, generator)
        else:
            loss, lo = halo_eval_step(model, sh, self.group, pos_weight, cfg)
        logits = gather_edges(sh, self.group, lo)
        if logits is None:              # not rank 0: the loss is the same
            return {"loss": float(loss)}
        return compute_metrics(logits, unit.y, float(loss))


def _run_epoch(ds, model, opt, pos_weight, cfg, rng_np, generator, device,
               training: bool, halo: _HaloRunner | None = None) -> dict:
    metrics_list = []
    order = list(range(len(ds)))
    if training:
        random.shuffle(order)  # train.py:305
    for i in order:
        _, graph = ds[i]
        for unit in host_units(graph, cfg, rng_np, shuffle_parts=training):
            if halo is not None:
                metrics_list.append(halo.run_unit(unit, model, opt,
                                                  pos_weight, cfg, generator,
                                                  training))
                continue
            ex = make_example(unit.in_deg, unit.out_deg, unit.e_feat, unit.y,
                              unit.src, unit.dst, unit.n_nodes, device,
                              cfg.model)
            if training:
                loss, logits = train_step(model, opt, ex, pos_weight, cfg,
                                          generator)
            else:
                loss, logits = eval_step(model, ex, pos_weight, cfg)
            metrics_list.append(compute_metrics(
                logits.cpu().numpy(), ex.labels_host, float(loss)))
    return average_epoch_metrics(metrics_list) if metrics_list else {}


# ------------------------------------------------------------- checkpoints
def _rng_state(rng_np, generator, group=None) -> dict:
    """Every RNG the loop draws from, as plain arrays: Python's (shuffles),
    numpy's (masking, clusters) and the dropout generator (in a group,
    every rank's, ``[P, ...]``: the state of rank r in row r)."""
    version, words, gauss = random.getstate()
    drop = generator.get_state()
    if group is not None:
        drop = torch.stack([t.cpu() for t in group.all_gather(drop)])
    return {"python_version": np.int64(version),
            "python_words": np.asarray(words, dtype=np.int64),
            "python_gauss": np.asarray([] if gauss is None else [gauss],
                                       dtype=np.float64),
            "numpy": np.asarray(json.dumps(rng_np.bit_generator.state)),
            "dropout": drop.numpy()}


def _set_rng_state(st: dict, rng_np, generator, group=None) -> None:
    gauss = st["python_gauss"]
    random.setstate((int(st["python_version"]),
                     tuple(int(w) for w in st["python_words"]),
                     float(gauss[0]) if gauss.size else None))
    rng_np.bit_generator.state = json.loads(str(st["numpy"]))
    drop = st["dropout"]
    if group is not None:
        if drop.ndim != 2 or drop.shape[0] != group.size:
            raise ValueError(f"checkpoint holds dropout states for "
                             f"{drop.shape[0] if drop.ndim == 2 else 1} "
                             f"rank(s), the run has {group.size}")
        drop = drop[group.rank]
    elif drop.ndim != 1:
        raise ValueError(f"checkpoint holds dropout states for "
                         f"{drop.shape[0]} ranks; resume it with "
                         f"compute.mesh={drop.shape[0]}")
    generator.set_state(torch.as_tensor(drop))


def _save_ckpt(path, epoch, model, opt, scheduler, loss_train, loss_valid,
               rng_np, generator, group=None):
    params, state = pytrees_from_model(model)
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
    rng = _rng_state(rng_np, generator, group)
    if group is None or group.rank == 0:
        save_pytrees(path, params=params, state=state, opt=moments, meta=meta,
                     rng=rng)


def _load_ckpt(path, model, opt, scheduler, rng_np, generator, device,
               group=None):
    """Restores everything ``_save_ckpt`` wrote; returns (start_epoch,
    loss_train, loss_valid).  In a group rank 0 reads the file and sends
    its arrays to the others."""
    if group is None:
        trees = load_pytrees(path)
    else:
        trees = group.broadcast(load_pytrees(path) if group.rank == 0
                                else None)
    load_model_pytrees(model, trees["params"], trees.get("state", {}))
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
    _set_rng_state(trees["rng"], rng_np, generator, group)
    return (int(meta["epoch"]) + 1,
            [float(v) for v in np.atleast_1d(meta["loss_train"])],
            [float(v) for v in np.atleast_1d(meta["loss_valid"])])


def _train_rank(group, *args):
    return train(*args, group=group)


def train(train_path: str, valid_path: str, assembler: str,
          out_name: str | None = None, overfit: bool = False,
          resume: bool = False, cfg: Config | None = None,
          group=None) -> str:
    """Train the edge scorer ``cfg.model`` names (the SymGatedGCN or a zoo
    model); returns the best-model path.  With ``compute.mesh > 1`` and no
    ``group`` it spawns the ranks and returns rank 0's result (in a
    launcher's rank: joins its group, and returns this rank's)."""
    from ..parallel.group import run, wants_group

    cfg = cfg or Config()
    if group is None and wants_group(cfg.compute.mesh):
        check_compute(cfg, "train")
        return run(_train_rank, cfg.compute.mesh, train_path, valid_path,
                   assembler, out_name, overfit, resume, cfg,
                   device=cfg.compute.device)
    lead = group is None or group.rank == 0
    device = (resolve_device(cfg.compute.device) if group is None
              else group.device)
    rng_np, _ = set_seed(cfg.train.seed)
    halo = None
    if group is None:
        generator = torch.Generator(device=device).manual_seed(cfg.train.seed)
    else:
        from ..parallel.halo import dropout_generator
        generator = dropout_generator(cfg.train.seed, group.rank, device)
        halo = _HaloRunner(group)

    timestamp = datetime.now().strftime("%Y-%b-%d-%H-%M-%S")
    out = (out_name or timestamp) + f"_seed{cfg.train.seed}"
    if group is not None:               # one name for every rank: rank 0's
        out = group.broadcast(out)

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
    model = get_model(cfg.model).init_weights(cfg.train.seed)
    model.to(device)
    opt = make_optimizer(model, cfg.train.lr)
    scheduler = ReduceLROnPlateau(cfg.train.lr, factor=cfg.train.decay,
                                  patience=cfg.train.patience)

    start_epoch = 0
    loss_train_hist: list[float] = []
    loss_valid_hist: list[float] = []
    if resume:
        start_epoch, loss_train_hist, loss_valid_hist = _load_ckpt(
            ckpt_path, model, opt, scheduler, rng_np, generator, device,
            group)
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
    print(f"Model: {cfg.model.model}  "
          f"normalization: {cfg.model.normalization}  "
          f"pos_weight: {pos_weight:.4f}")
    if group is not None:
        print(f"Ranks: {group.size} ({group.backend}), halo-exchange graph "
              "parallelism")
    print("---------------------------------------")

    logger = (JsonlLogger(os.path.join(ckpts_path, f"log_{out}.jsonl"),
                          cfg.wandb_mode, cfg.wandb_project, out,
                          cfg.to_dict()) if lead else None)

    def save_best():
        if lead:
            save_model_weights(model_path, *pytrees_from_model(model))

    def save_ckpt(epoch):
        _save_ckpt(ckpt_path, epoch, model, opt, scheduler, loss_train_hist,
                   loss_valid_hist, rng_np, generator, group)

    def log_epoch(log):
        if halo is not None:
            from ..ops.kernels import reset_launch_counts
            from ..parallel.halo import rank_launches
            log["halo_routes"] = dict(halo.routes)
            log["halo_launches"] = rank_launches(group)
            halo.routes.clear()
            reset_launch_counts()
        if lead:
            logger.log(log)

    try:
        for epoch in range(start_epoch, cfg.train.num_epochs):
            t0 = time.time()
            set_learning_rate(opt, scheduler.lr)
            m_train = _run_epoch(ds_train, model, opt, pos_weight, cfg,
                                 rng_np, generator, device, training=True,
                                 halo=halo)
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
                          f"f1={m_train.get('f1', float('nan')):.4f}")
                scheduler.step(m_train["loss"])
                save_ckpt(epoch)
                log_epoch(log)
                print(f"Epoch {epoch} ({time.time()-t0:.1f}s): "
                      f"train loss {m_train['loss']:.6f}")
                continue

            m_valid = _run_epoch(ds_valid, model, opt, pos_weight, cfg,
                                 rng_np, generator, device, training=False,
                                 halo=halo)
            loss_valid_hist.append(m_valid["loss"])
            log.update({f"valid/{k}": v for k, v in m_valid.items()})
            log["epoch_wall_s"] = round(time.time() - t0, 2)

            if len(loss_valid_hist) == 1 or \
                    loss_valid_hist[-1] < min(loss_valid_hist[:-1]):
                save_best()
                print(f"Epoch {epoch}: model saved! valid_loss="
                      f"{m_valid['loss']:.6f} "
                      f"f1={m_valid.get('f1', float('nan')):.4f}")
            scheduler.step(m_valid["loss"])
            save_ckpt(epoch)
            log_epoch(log)
            print(f"Epoch {epoch} ({time.time()-t0:.1f}s): "
                  f"train {m_train['loss']:.6f} valid {m_valid['loss']:.6f} "
                  f"lr {scheduler.lr:.2e}")
    except KeyboardInterrupt:
        print("Keyboard Interrupt... Exiting...")
    finally:
        if logger is not None:
            logger.close()

    return model_path
