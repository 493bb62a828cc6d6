"""The benchmark's parts, found by name under its folder: data files
(``<folder>/<name>.json``) and code files (``<folder>/<name>.py``), so
that a new configuration, mix, traffic kind, reference model or metric
is a new file and never an edit of one that is there."""

from __future__ import annotations

import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


def load_json(folder: str, name: str) -> dict:
    with open(os.path.join(BENCH_DIR, folder, name + ".json")) as fh:
        return json.load(fh)


def load_module(folder: str, name: str):
    """The module of ``<folder>/<name>.py``, loaded from its file (names
    may hold dots)."""
    path = os.path.join(BENCH_DIR, folder, name + ".py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"portbench: no {folder}/{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_{folder}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
