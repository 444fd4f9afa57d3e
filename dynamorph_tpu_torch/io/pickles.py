"""Pickle IO helpers — output formats stay byte-compatible with the reference
pipeline (protocol 4 for arrays, reference pipeline/patch_VAE.py:166, :457)
so the pipelines can be cross-checked stage by stage."""
from __future__ import annotations

import os
import pickle
from typing import Any


def load_pickle(path: str) -> Any:
    with open(path, "rb") as f:
        return pickle.load(f)


def save_pickle(obj: Any, path: str, protocol: int = 4) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(obj, f, protocol=protocol)
