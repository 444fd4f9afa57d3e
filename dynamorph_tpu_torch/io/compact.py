"""Compact (float32 .npz) array storage beside the reference pickle contract.

The reference pipeline writes ``<well>_static_patches.pkl`` and
``*_latent_space{,_after}.pkl`` as pickles (pipeline/patch_VAE.py:166,
:454-462); those stay the default. ``storage: compact`` in the
``latent_encoding`` config section writes uncompressed float32 ``.npz``
files (member ``data``) instead. Readers accept either extension, so mixed
trees written by either package load the same way.
"""
from __future__ import annotations

import logging
import os

import numpy as np

from .pickles import load_pickle, save_pickle

# resolve_any mtime tie window (seconds): differences at or below this are
# treated as "same age" — copied/extracted trees often land both siblings
# within the same second (or identical) even when their contents differ.
_MTIME_TIE_S = 2.0


def npz_path(path: str) -> str:
    """`foo.pkl` / `foo` -> `foo.npz`."""
    base, ext = os.path.splitext(path)
    return (base if ext in (".pkl", ".npz") else path) + ".npz"


def pkl_path(path: str) -> str:
    base, ext = os.path.splitext(path)
    return (base if ext in (".pkl", ".npz") else path) + ".pkl"


def storage_path(path: str, storage: str) -> str:
    """Rewrite an artifact path's extension for the selected storage."""
    if storage == "compact":
        return npz_path(path)
    if storage == "pickle":
        return pkl_path(path)
    raise ValueError(f"unknown storage {storage!r} "
                     "(expected 'pickle' or 'compact')")


def resolve_any(path: str) -> str:
    """Return the on-disk sibling of ``path`` (.pkl or .npz).

    Whichever extension exists; when BOTH exist the most recently modified
    wins (with a warning), unless the two mtimes are within ``_MTIME_TIE_S``
    of each other (a copied tree), when the requested extension wins.
    """
    cands = [path, npz_path(path) if not path.endswith(".npz")
             else pkl_path(path)]
    if all(os.path.exists(c) for c in cands):
        mtimes = [os.path.getmtime(c) for c in cands]
        if abs(mtimes[0] - mtimes[1]) <= _MTIME_TIE_S:
            return cands[0]  # tie (copied/synced tree): requested ext wins
        newest = cands[int(mtimes[1] > mtimes[0])]
        if newest != cands[0]:
            logging.getLogger(__name__).warning(
                "%s is older than its sibling %s — loading the newer file "
                "(mixed-storage tree; delete the stale artifact to silence "
                "this)", cands[0], newest)
        return newest
    for c in cands:
        if os.path.exists(c):
            return c
    return path


def save_array_compact(arr: np.ndarray, path: str,
                       dtype=np.float32) -> None:
    """Write one ndarray as an uncompressed .npz (member ``data``)."""
    path = npz_path(path)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    arr = np.asarray(arr)
    if dtype is not None and arr.dtype.kind == "f":
        arr = arr.astype(dtype, copy=False)
    np.savez(path, data=arr)


def load_array_compact(path: str) -> np.ndarray:
    with np.load(path, allow_pickle=False) as z:
        return z["data"]


def save_array(arr: np.ndarray, path: str, storage: str = "pickle") -> None:
    if storage == "compact":
        save_array_compact(arr, path)
    else:
        save_pickle(arr, pkl_path(path))


def load_array_any(path: str) -> np.ndarray:
    """Load an ndarray artifact named by either extension."""
    path = resolve_any(path)
    if path.endswith(".npz"):
        return load_array_compact(path)
    return load_pickle(path)
