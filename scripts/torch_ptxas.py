#!/usr/bin/env python3
"""The compiler's resource report for K3's passes, read from an ``nvcc
-Xptxas -v`` log (``build/nvcc.log``, which ``gnnome_tpu_torch.ops.kernels.
build_kernels`` writes).

    python3 scripts/torch_ptxas.py build/nvcc.log [OTHER/nvcc.log]

Prints one JSON object: for each instantiation of ``k3_pass_v`` and
``k3_pass_u`` in the log's ``k3_edge_stage.cu`` section, keyed by pass,
team size T, lanes' width V and element type, its registers, stack frame,
spill stores and loads and static shared memory (the ring is dynamic
shared memory, which the report leaves out).  With a second log (another
tree's build) it also compares the two and exits 1 when an instantiation
is missing from one or differs in any of these.
"""
from __future__ import annotations

import json
import re
import sys

_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers")
_SMEM = re.compile(r"(\d+) bytes smem")
COMPARED = ("registers", "stack", "spill_stores", "spill_loads", "smem")


def k3_resources(text: str, section: str = "k3_edge_stage.cu") -> dict:
    """{"k3_pass_v T=16 V=4 float": {registers, ...}, ...} for the K3
    passes compiled in ``section`` of the log."""
    out, name, in_section = {}, None, False
    for line in text.splitlines():
        if line.startswith("== "):
            in_section = line.startswith(f"== {section} ")
            continue
        if not in_section:
            continue
        m = _ENTRY.search(line)
        if m:
            name = m.group(1)
            continue
        if name is None or "k3_pass_" not in name:
            continue
        ints = [int(x) for x in re.findall(r"Li(\d+)E", name)]
        kind = "k3_pass_v" if "k3_pass_v" in name else "k3_pass_u"
        dtype = "bf16" if "bfloat16" in name else "float"
        key = f"{kind} T={ints[-2]} V={ints[-1]} {dtype}"
        r = out.setdefault(key, {})
        m = _FRAME.search(line)
        if m:
            r["stack"], r["spill_stores"], r["spill_loads"] = map(
                int, m.groups())
        m = _USED.search(line)
        if m:
            r["registers"] = int(m.group(1))
            m = _SMEM.search(line)
            r["smem"] = int(m.group(1)) if m else 0
    return out


def main(argv) -> int:
    if len(argv) not in (1, 2):
        print(__doc__, file=sys.stderr)
        return 2
    reports = []
    for path in argv:
        with open(path) as f:
            reports.append(k3_resources(f.read()))
    result = {"logs": argv, "k3": reports[0]}
    ok = bool(reports[0])
    if len(reports) == 2:
        a, b = reports
        diff = {k: {"first": a.get(k), "second": b.get(k)}
                for k in sorted(set(a) | set(b))
                if k not in a or k not in b
                or any(a[k].get(c) != b[k].get(c) for c in COMPARED)}
        result.update(second=b, differ=diff)
        ok = ok and not diff
    result["same"] = ok
    print(json.dumps(result, indent=1))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
