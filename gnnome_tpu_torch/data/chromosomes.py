"""Train/valid chromosome selection (reference train_valid_chrs.py).

The reference hardcodes two dicts in a Python module; here the same shape is a
JSON file (``{"train": {"chr19_hg002": 1, ...}, "valid": {...}}``) with the
reference's shipped defaults built in.
"""
from __future__ import annotations

import json

_DEFAULT_TRAIN = {"chr18_hg002": 1, "chr20_hg002": 1}
_DEFAULT_VALID = {"chr19_hg002": 1, "chr20_hg002": 1}


def get_train_valid_chrs(config_path: str | None = None):
    if config_path:
        with open(config_path) as f:
            d = json.load(f)
        return d["train"], d["valid"]
    return dict(_DEFAULT_TRAIN), dict(_DEFAULT_VALID)


def merge_dicts(d1: dict, d2: dict, d3: dict | None = None) -> dict:
    """Per-key sum (reference generate_data.py:63-66)."""
    d3 = d3 or {}
    keys = {*d1, *d2, *d3}
    return {k: d1.get(k, 0) + d2.get(k, 0) + d3.get(k, 0) for k in keys}
