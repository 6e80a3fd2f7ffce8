"""TOML config loading (the reference's two-document surface).

The reference loads two TOML files with ``tomli`` (run_simulation.py:232-240):
an SFM parameter document and a scenario document.  Both of the reference's
shipped files parse unchanged here.  A copy of the JAX package's loader.
"""
from __future__ import annotations

import tomllib
from pathlib import Path


def load_toml(path: str | Path) -> dict:
    with open(path, "rb") as fp:
        return tomllib.load(fp)


def load_config(path_or_dict) -> dict:
    """Accept a path to a TOML file or an already-parsed dict."""
    if isinstance(path_or_dict, dict):
        return path_or_dict
    return load_toml(path_or_dict)
