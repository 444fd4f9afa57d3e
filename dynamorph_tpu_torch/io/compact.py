"""Compact (float32 .npz) storage beside the reference pickle contract.

The reference pipeline writes ``stacks_<t>.pkl`` patch dicts
(extract_patches.py:270-272), ``<well>_static_patches.pkl`` and
``*_latent_space{,_after}.pkl`` as pickles (pipeline/patch_VAE.py:166,
:454-462); those stay the default. ``storage: compact`` in the ``patch`` or
``latent_encoding`` config section writes uncompressed float32 ``.npz``
files instead. Readers accept either extension, so mixed trees written by
either package load the same way.

Two container layouts, told apart by their members:

- stack: ``keys`` (N patch names), ``mat`` and ``masked_mat``
  (N, C, Z, H, W) float32, a ``stacks_<t>.pkl`` dict flattened. Patch
  values are float32 on the device and the masks 0/1, so a stack's float64
  pickle and its float32 npz hold the same numbers;
- array: ``data``, one ndarray (static patches, latents).
"""
from __future__ import annotations

import logging
import os
from typing import Dict

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
    """Return the on-disk sibling of ``path`` (.pkl or .npz): whichever
    extension exists. When BOTH exist the most recently modified wins (with
    a warning), unless the two mtimes are within ``_MTIME_TIE_S`` of each
    other (a copied tree), when the requested extension wins.
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


# ---------------------------------------------------------------- stacks


def save_stack_compact(site_data: Dict[str, dict], path: str) -> None:
    """Write a ``stacks_<t>`` dict as a float32 .npz (uncompressed). All
    patches of a frame share one shape (pipeline/patch.py::
    assemble_site_data), so the container is a dense stack."""
    path = npz_path(path)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    keys = sorted(site_data.keys())
    if keys:
        mat = np.stack([np.asarray(site_data[k]["mat"]) for k in keys]
                       ).astype(np.float32)
        masked = np.stack(
            [np.asarray(site_data[k]["masked_mat"]) for k in keys]
        ).astype(np.float32)
    else:
        mat = np.zeros((0,), np.float32)
        masked = np.zeros((0,), np.float32)
    np.savez(path, keys=np.asarray(keys, dtype=np.str_), mat=mat,
             masked_mat=masked)


def load_stack_compact(path: str) -> Dict[str, dict]:
    """Read a compact stack back into the reference dict layout. Arrays
    come back float32; the cast to float64 is exact for patch data and is
    left to the caller that needs it."""
    with np.load(path, allow_pickle=False) as z:
        keys = [str(k) for k in z["keys"]]
        mat, masked = z["mat"], z["masked_mat"]
    return {k: {"mat": mat[i], "masked_mat": masked[i]}
            for i, k in enumerate(keys)}


def save_stack(site_data: Dict[str, dict], path: str,
               storage: str = "pickle") -> None:
    if storage == "compact":
        save_stack_compact(site_data, path)
    else:
        save_pickle(site_data, pkl_path(path))


def load_stack_any(path: str) -> Dict[str, dict]:
    """Load a ``stacks_<t>`` dict named by either extension."""
    path = resolve_any(path)
    if path.endswith(".npz"):
        return load_stack_compact(path)
    return load_pickle(path)


# ---------------------------------------------------------------- arrays


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
