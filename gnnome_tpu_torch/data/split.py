"""Train/valid dataset splitting (reference split_data.py:10-107).

Copies ``<datadir>/<chrN>/<assembler>/processed/{i}.npz`` (plus read stores
and aux maps) into ``train_<name>/`` and ``valid_<name>/`` directory trees and
records the graph->chromosome / graph->origin-index maps.
"""
from __future__ import annotations

import os
import pickle
import shutil
from datetime import datetime


def _copy_graph(src_dir: str, i: int, dst_dir: str, n: int) -> bool:
    src_prc = os.path.join(src_dir, "processed", f"{i}.npz")
    if not os.path.isfile(src_prc):
        print(f"split: missing {src_prc}")
        return False
    shutil.copy(src_prc, os.path.join(dst_dir, "processed", f"{n}.npz"))
    for suffix in ("reads.npz", "aux.pkl"):
        src_info = os.path.join(src_dir, "info", f"{i}_{suffix}")
        if os.path.isfile(src_info):
            shutil.copy(src_info, os.path.join(dst_dir, "info", f"{n}_{suffix}"))
    return True


def _resolve_chr_dir(data_path: str, chr_flag: str, assembler: str) -> tuple[str, str]:
    if "+" in chr_flag:
        return chr_flag, os.path.join(data_path, "combo", chr_flag, assembler)
    if chr_flag.endswith("_hg002"):
        chrN = chr_flag[:-6]
        return chrN, os.path.join(data_path, chrN, assembler)
    if chr_flag.endswith("_other"):
        chrN = chr_flag[:-6]
        return chrN, os.path.join(data_path, "..", "other", chrN, assembler)
    raise ValueError(f"Chromosome flag needs a proper suffix: {chr_flag}")


def train_valid_split(data_path: str, savedir: str, assembler: str,
                      train_dict: dict, valid_dict: dict,
                      name: str | None = None) -> tuple[str, str]:
    data_path = os.path.abspath(data_path)
    if name is None:
        name = datetime.now().strftime("%Y-%b-%d-%H-%M-%S")

    assemblers = ["hifiasm", "raven"] if assembler == "both" else [assembler]
    out_dirs = {}
    for split, chr_dict, offset_dict in (
            ("train", train_dict, {}), ("valid", valid_dict, train_dict)):
        split_dir = os.path.join(savedir, f"{split}_{name}")
        g_to_chr, g_to_org = {}, {}
        n_have = 0
        for asm in assemblers:
            dst = os.path.join(split_dir, asm)
            os.makedirs(os.path.join(dst, "processed"), exist_ok=True)
            os.makedirs(os.path.join(dst, "info"), exist_ok=True)
            for chr_flag, n_need in chr_dict.items():
                chrN, src_dir = _resolve_chr_dir(data_path, chr_flag, asm)
                for i in range(n_need):
                    j = i + (offset_dict.get(chr_flag, 0) if split == "valid" else 0)
                    if _copy_graph(src_dir, j, dst, n_have):
                        g_to_chr[n_have] = chrN
                        g_to_org[n_have] = j
                        n_have += 1
            with open(os.path.join(dst, "info", "g_to_chr.pkl"), "wb") as f:
                pickle.dump(g_to_chr, f)
            with open(os.path.join(dst, "info", "g_to_org_g.pkl"), "wb") as f:
                pickle.dump(g_to_org, f)
        out_dirs[split] = split_dir
        print(f"{split} data saved in: {split_dir} ({n_have} graphs)")
    return out_dirs["train"], out_dirs["valid"]
