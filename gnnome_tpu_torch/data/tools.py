"""External assembler/simulator installation (reference install_tools.py:6-53).

Clones + builds hifiasm 0.18.8, Raven 1.8.1 (print_graphs branch) and PBSIM3
into the configured tool dir.  Network access is required; failures are
reported per tool and do not abort the others.
"""
from __future__ import annotations

import os
import subprocess

from ..config import Config


def _run(cmd: str, cwd: str) -> bool:
    try:
        subprocess.run(cmd, shell=True, cwd=cwd, check=True)
        return True
    except subprocess.CalledProcessError as e:
        print(f"[install-tools] command failed ({e.returncode}): {cmd}")
        return False


def install_tools(cfg: Config | None = None) -> None:
    cfg = cfg or Config()
    save_dir = cfg.paths.tool_dir
    os.makedirs(save_dir, exist_ok=True)

    hifiasm_dir = cfg.paths.hifiasm_dir
    if os.path.isfile(os.path.join(hifiasm_dir, "hifiasm")):
        print("Found hifiasm! Skipping installation...")
    else:
        print("Installing hifiasm...")
        name = os.path.basename(hifiasm_dir)
        if _run("git clone https://github.com/chhylp123/hifiasm.git "
                f"--branch 0.18.8 --single-branch {name}", save_dir):
            _run("make", hifiasm_dir)

    raven_dir = cfg.paths.raven_dir
    if os.path.isfile(os.path.join(raven_dir, "build", "bin", "raven")):
        print("Found raven! Skipping installation...")
    else:
        print("Installing Raven...")
        name = os.path.basename(raven_dir)
        if _run("git clone https://github.com/lbcb-sci/raven.git "
                f"--branch print_graphs --single-branch {name}", save_dir):
            _run("cmake -S ./ -B./build -DRAVEN_BUILD_EXE=1 "
                 "-DCMAKE_BUILD_TYPE=Release", raven_dir)
            _run("cmake --build build", raven_dir)

    pbsim_dir = cfg.paths.pbsim3_dir
    if os.path.isfile(os.path.join(pbsim_dir, "src", "pbsim")):
        print("Found pbsim! Skipping installation...")
    else:
        print("Installing PBSIM3...")
        name = os.path.basename(pbsim_dir)
        if _run(f"git clone https://github.com/yukiteruono/pbsim3.git {name}",
                save_dir):
            _run("./configure; make", pbsim_dir)


def download_profile(cfg: Config | None = None) -> str:
    """Fetch the PBSIM3 sample profile archive into the PBSIM3 tool dir
    (reference download_profile.sh:1-19).  Returns the PBSIM3 directory.

    Tries wget then curl; requires PBSIM3 to be installed first, exactly as
    the reference script does.
    """
    import shutil

    cfg = cfg or Config()
    pbsim_dir = cfg.paths.pbsim3_dir
    if not os.path.isdir(pbsim_dir):
        raise FileNotFoundError(
            f"Directory {pbsim_dir} does not exist! Install PBSIM3 by "
            "running 'gnnome-tpu-torch install-tools' first, or change "
            "paths.pbsim3_dir (reference download_profile.sh:15-17)")
    url = ("https://www.dropbox.com/scl/fo/kqmr2fjo5yaqrdycfxv8k/h"
           "?rlkey=sff6e5aqvngvxjk12xka3yjww&e=1&dl=0")
    zip_path = os.path.join(pbsim_dir, "download.zip")
    print(f"Downloading PBSIM3 profile into {pbsim_dir} ...")
    fetched = False
    if shutil.which("wget"):
        fetched = _run(f"wget -O download.zip '{url}'", pbsim_dir)
    if not fetched and shutil.which("curl"):
        fetched = _run(f"curl -L -o download.zip '{url}'", pbsim_dir)
    if not fetched:
        raise RuntimeError("Could not download the profile "
                           "(wget/curl missing or network unavailable)")
    print("Extracting files ...")
    if shutil.which("unzip"):
        ok = _run("unzip -o download.zip", pbsim_dir)
    else:
        import zipfile
        with zipfile.ZipFile(zip_path) as z:
            z.extractall(pbsim_dir)
        ok = True
    os.remove(zip_path)
    if ok:
        print("Successful!")
    return pbsim_dir
