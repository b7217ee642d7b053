"""gnnome-tpu-torch command-line interface.

Every subcommand of ``gnnome_tpu.cli``, with the same flags:

    python -m gnnome_tpu_torch.cli run -r READS -o OUT [-t N] [-m MODEL]
    python -m gnnome_tpu_torch.cli build-graph --gfa G.gfa --reads R.fasta \\
        --asm hifiasm|raven --out DS [--training] [--threads N]
    python -m gnnome_tpu_torch.cli infer --data DS --asm hifiasm --out DS/hifiasm \\
        --model weights/weights.npz [--set compute.device=cpu] [--set SEC.KEY=VAL]
    python -m gnnome_tpu_torch.cli train --train DS --valid DS --asm hifiasm \\
        [--name NAME] [--overfit] [--resume] [--dropout P] [--seed N] [--set ...]
    python -m gnnome_tpu_torch.cli generate-data --datadir D --chrdir C --asm hifiasm
    python -m gnnome_tpu_torch.cli split-data --datadir D --savedir S --asm hifiasm
    python -m gnnome_tpu_torch.cli evaluate --assembly A.fasta [--ref-length N | --chr chr19]
    python -m gnnome_tpu_torch.cli convert-weights SRC.npz|pt DST.pt|npz
    python -m gnnome_tpu_torch.cli install-tools | download-profile

``run`` is hifiasm, then ``build-graph``, then ``infer``.  ``infer``,
``train`` and ``run`` put the model on the GPU unless ``--set
compute.device=cpu`` asks for the CPU; the other subcommands are host code.
With ``--set compute.mesh=P`` (P > 1) ``infer`` and ``train``, started
alone, spawn P ranks that split each graph between them: ``infer`` for
every model (the batch-norm SymGatedGCN on ``parallel/halo.py``, the others
on ``parallel/sharded.py``), ``train`` for the batch-norm SymGatedGCN (it
refuses the others, which the JAX package trains on one device); the
command exits nonzero if any rank fails.
"""
from __future__ import annotations

import argparse
import os
import shlex
import subprocess
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


def cmd_run(args):
    """End-to-end: reads -> hifiasm -> graph -> scores -> contigs
    (reference run.py:9-42)."""
    cfg = _load_cfg(args)
    out = args.out
    hifiasm = os.path.abspath(os.path.join(cfg.paths.hifiasm_dir, "hifiasm"))
    hifiasm_out = os.path.join(out, "hifiasm", "output")
    os.makedirs(hifiasm_out, exist_ok=True)
    print(f"Step 1: hifiasm on {args.reads}")
    subprocess.run(
        f"{shlex.quote(hifiasm)} --prt-raw -o {shlex.quote(hifiasm_out)}/asm "
        f"-t{args.threads} -l0 {shlex.quote(args.reads)}",
        shell=True, check=True)
    gfa = os.path.join(hifiasm_out, "asm.bp.raw.r_utg.gfa")
    print("Step 2: building the inference graph")
    _build_graph(gfa, args.reads, out, "hifiasm", cfg, threads=int(args.threads))
    print(f"Step 3: inference with model {args.model}")
    from .infer import run_inference
    summary = run_inference(out, args.model, "hifiasm",
                            os.path.join(out, "hifiasm"), cfg)
    print(f"Assembly saved in: {out}/hifiasm/assembly/0_assembly.fasta")
    return summary


def _build_graph(gfa, reads, out_dir, assembler, cfg, training=False,
                 threads=1) -> dict:
    """Graph 0 of the dataset ``out_dir``; returns the seconds of each
    stage."""
    from .data.dataset import dataset_for
    ds = dataset_for(assembler, out_dir, threads=threads, config=cfg)
    return ds.save_parsed(0, gfa, reads, training=training)


def cmd_build_graph(args):
    """GFA + reads -> processed graph dir (reference
    create_inference_graphs.py).  Returns the stages' seconds
    (``timing``) and the process's peak RSS (``peak_rss_mb``)."""
    import resource

    cfg = _load_cfg(args)
    assert os.path.isfile(args.gfa), "GFA not found!"
    assert os.path.isfile(args.reads), "Reads not found!"
    timing = _build_graph(args.gfa, args.reads, args.out, args.asm, cfg,
                          training=args.training, threads=args.threads)
    rss_mb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
    print("Graph processed.")
    print(", ".join(f"{k}: {v:.2f}s" for k, v in timing.items())
          + f"; peak host memory: {rss_mb:.0f} MB")
    return {"timing": timing, "peak_rss_mb": rss_mb}


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


def cmd_generate_data(args):
    """Simulate reads + build graphs (reference generate_data.py)."""
    cfg = _load_cfg(args)
    from .data.simulate import simulate_and_generate
    simulate_and_generate(args.datadir, args.chrdir, args.asm, args.threads, cfg)


def cmd_split_data(args):
    """Copy processed graphs into train/valid dirs (reference split_data.py)."""
    _load_cfg(args)
    from .data.chromosomes import get_train_valid_chrs
    from .data.split import train_valid_split
    train_dict, valid_dict = get_train_valid_chrs(args.chrs_config)
    return train_valid_split(args.datadir, args.savedir, args.asm, train_dict,
                             valid_dict, args.name)


def cmd_install_tools(args):
    cfg = _load_cfg(args)
    from .data.tools import install_tools
    install_tools(cfg)


def cmd_download_profile(args):
    """Fetch the PBSIM3 sample profile (reference download_profile.sh)."""
    cfg = _load_cfg(args)
    from .data.tools import download_profile
    return download_profile(cfg)


def cmd_evaluate(args):
    """Assembly contiguity metrics (reference utils/evaluate.py:93-105), with
    optional external minigraph/paftools NG50/NGA50 (evaluate.py:139-157)."""
    cfg = _load_cfg(args)
    from .decode.assembly import (CHM13_CHR_LENS, parse_minigraph_report,
                                  parse_pafs, quick_evaluation, run_minigraph)
    from .utils.fastx import read_fastx

    contigs = list(read_fastx(args.assembly))
    ref_length = args.ref_length
    if ref_length is None and args.chr:
        ref_length = CHM13_CHR_LENS.get(args.chr)
    ev = quick_evaluation(contigs, ref_length=ref_length)
    for k, v in ev.items():
        print(f"{k}:\t{v}")

    if args.ref:
        outdir = args.out or os.path.dirname(os.path.abspath(args.assembly))
        paf = os.path.join(outdir, "asm.paf")
        report = os.path.join(outdir, "minigraph.txt")
        p = run_minigraph(args.ref, args.assembly, paf,
                          minigraph=cfg.paths.minigraph)
        if p.wait() != 0:
            raise SystemExit(f"minigraph failed (rc={p.returncode}); "
                             f"no NG50/NGA50 computed")
        idx = args.ref + ".fai"
        if not os.path.isfile(idx):
            raise SystemExit(f"missing reference index {idx} "
                             f"(run: samtools faidx {args.ref})")
        p = parse_pafs(idx, report, paf, paftools=cfg.paths.paftools)
        if p.wait() != 0:
            raise SystemExit(f"paftools failed (rc={p.returncode}); "
                             f"no NG50/NGA50 computed")
        print(parse_minigraph_report(report))
    return ev


def cmd_convert_weights(args):
    """Batch-norm SymGatedGCN weights between the reference's torch ``.pt``
    state dict and the native npz, either way (each file's format from its
    suffix)."""
    _load_cfg(args)
    from .models.checkpoint import load_model_weights, save_model_weights
    params, state = load_model_weights(args.src)
    if args.dst.endswith(".pt"):
        import torch
        from .models.convert import module_state_from_numpy
        torch.save(module_state_from_numpy(params, state, "batch"), args.dst)
    else:
        save_model_weights(args.dst, params, state)
    print(f"Converted {args.src} -> {args.dst}")


def main(argv=None):
    """Parse ``argv`` and run the subcommand; returns its result (for
    ``infer`` and ``run`` the ``run_inference`` summary, for ``train`` the
    best-model path, for ``build-graph`` its stage times and peak RSS, for
    ``split-data`` the two directories, for ``evaluate`` the metrics)."""
    parser = argparse.ArgumentParser(prog="gnnome-tpu-torch",
                                     description=__doc__.split("\n")[0])
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("run", help="end-to-end assembly from reads")
    p.add_argument("-r", "--reads", required=True)
    p.add_argument("-o", "--out", default=".")
    p.add_argument("-t", "--threads", type=int, default=1)
    p.add_argument("-m", "--model", default="weights/weights.npz")
    _add_common(p)
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("build-graph", help="GFA + reads -> processed graph")
    p.add_argument("--gfa", required=True)
    p.add_argument("--reads", required=True)
    p.add_argument("--asm", required=True, choices=["hifiasm", "raven"])
    p.add_argument("--out", required=True)
    p.add_argument("--training", action="store_true",
                   help="parse GT labels from read headers")
    p.add_argument("--threads", type=int, default=1)
    _add_common(p)
    p.set_defaults(fn=cmd_build_graph)

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

    p = sub.add_parser("generate-data", help="simulate reads + build graphs")
    p.add_argument("--datadir", required=True)
    p.add_argument("--chrdir", required=True)
    p.add_argument("--asm", required=True)
    p.add_argument("--threads", type=int, default=1)
    _add_common(p)
    p.set_defaults(fn=cmd_generate_data)

    p = sub.add_parser("split-data", help="split processed graphs train/valid")
    p.add_argument("--datadir", required=True)
    p.add_argument("--savedir", required=True)
    p.add_argument("--asm", required=True)
    p.add_argument("--name", default=None)
    p.add_argument("--chrs-config", default=None,
                   help="JSON file with train/valid chromosome counts")
    _add_common(p)
    p.set_defaults(fn=cmd_split_data)

    p = sub.add_parser("install-tools", help="clone+build hifiasm/raven/pbsim3")
    _add_common(p)
    p.set_defaults(fn=cmd_install_tools)

    p = sub.add_parser("download-profile",
                       help="fetch the PBSIM3 sample profile archive")
    _add_common(p)
    p.set_defaults(fn=cmd_download_profile)

    p = sub.add_parser("evaluate", help="assembly contiguity metrics")
    p.add_argument("--assembly", required=True, help="contigs FASTA")
    p.add_argument("--ref-length", type=int, default=None,
                   help="reference length for NG50")
    p.add_argument("--chr", default=None,
                   help="CHM13 chromosome name for NG50 (e.g. chr19)")
    p.add_argument("--ref", default=None,
                   help="reference FASTA for external minigraph NG50/NGA50")
    p.add_argument("--out", default=None, help="dir for paf/report outputs")
    _add_common(p)
    p.set_defaults(fn=cmd_evaluate)

    p = sub.add_parser("convert-weights", help="torch .pt <-> native .npz")
    p.add_argument("src")
    p.add_argument("dst")
    _add_common(p)
    p.set_defaults(fn=cmd_convert_weights)

    args = parser.parse_args(argv)
    return args.fn(args)


def entry() -> None:
    """Console-script entry point: exit status 0 unless the command raises."""
    main()


if __name__ == "__main__":
    entry()
