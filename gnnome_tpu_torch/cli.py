"""gnnome-tpu-torch command-line interface.

The ``infer`` and ``train`` subcommands of ``gnnome_tpu.cli`` with the same
flags:

    python -m gnnome_tpu_torch.cli infer --data DS --asm hifiasm --out DS/hifiasm \\
        --model weights/weights.npz [--set compute.device=cpu] [--set SEC.KEY=VAL]
    python -m gnnome_tpu_torch.cli train --train DS --valid DS --asm hifiasm \\
        [--name NAME] [--overfit] [--resume] [--dropout P] [--seed N] [--set ...]

Both run on the GPU unless ``--set compute.device=cpu`` asks for the CPU.
The other subcommands of ``gnnome_tpu.cli`` are not ported yet.
"""
from __future__ import annotations

import argparse
from contextlib import contextmanager

from .config import Config


def _add_common(p: argparse.ArgumentParser):
    p.add_argument("--config", type=str, default=None, help="JSON config file")
    p.add_argument("--set", action="append", default=[], metavar="SEC.KEY=VAL",
                   help="config override, e.g. --set decode.len_threshold=50000")


def _load_cfg(args) -> Config:
    cfg = Config.load(args.config) if args.config else Config()
    cfg.apply_overrides(args.set)
    return cfg


@contextmanager
def _maybe_trace(trace_dir: str | None):
    """torch.profiler trace (CPU + CUDA activity) into ``trace_dir``."""
    if not trace_dir:
        yield
        return
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))


def cmd_infer(args):
    """Dataset -> contigs (reference inference.py:504-519)."""
    cfg = _load_cfg(args)
    from .infer import run_inference
    with _maybe_trace(args.profile):
        return run_inference(args.data, args.model, args.asm, args.out, cfg)


def cmd_train(args):
    """Train the model (reference train.py:497-512)."""
    cfg = _load_cfg(args)
    if args.dropout is not None:
        cfg.model.dropout = args.dropout
    if args.seed is not None:
        cfg.train.seed = args.seed
    from .train.loop import train
    return train(train_path=args.train, valid_path=args.valid,
                 assembler=args.asm, out_name=args.name,
                 overfit=args.overfit, resume=args.resume, cfg=cfg)


def main(argv=None):
    """Parse ``argv`` and run the subcommand; returns its result (for
    ``infer`` the ``run_inference`` summary, for ``train`` the best-model
    path)."""
    parser = argparse.ArgumentParser(prog="gnnome-tpu-torch",
                                     description=__doc__.split("\n")[0])
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("infer", help="score + decode a processed dataset")
    p.add_argument("--data", required=True)
    p.add_argument("--asm", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--model", default="weights/weights.npz")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace to DIR/trace.json")
    _add_common(p)
    p.set_defaults(fn=cmd_infer)

    p = sub.add_parser("train", help="train the edge-scoring model")
    p.add_argument("--train", required=True)
    p.add_argument("--valid", required=True)
    p.add_argument("--asm", required=True)
    p.add_argument("--name", default=None)
    p.add_argument("--overfit", action="store_true")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--dropout", type=float, default=None)
    p.add_argument("--seed", type=int, default=None)
    _add_common(p)
    p.set_defaults(fn=cmd_train)

    args = parser.parse_args(argv)
    return args.fn(args)


def entry() -> None:
    """Console-script entry point: exit status 0 unless the command raises."""
    main()


if __name__ == "__main__":
    entry()
