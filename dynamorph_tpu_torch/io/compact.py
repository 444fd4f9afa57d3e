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
from typing import Any, Dict, Optional

import numpy as np

from .pickles import load_pickle, save_pickle

# resolve_any mtime tie window (seconds): differences at or below this are
# treated as "same age" — copied/extracted trees often land both siblings
# within the same second (or identical) even when their contents differ.
_MTIME_TIE_S = 2.0

# the members of a stack container
STACK_MEMBERS = ("keys", "mat", "masked_mat")


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


# ------------------------------------------------------------- converter


def _is_stack_dict(obj: Any) -> bool:
    return isinstance(obj, dict) and all(
        isinstance(v, dict) and "mat" in v and "masked_mat" in v
        for v in obj.values())


def _pickle_to_compact(src: str, dst: str) -> str:
    obj = load_pickle(src)
    if _is_stack_dict(obj):
        save_stack_compact(obj, dst)
        return npz_path(dst)
    if not isinstance(obj, np.ndarray):
        raise ValueError(
            f"{src}: unsupported pickle content {type(obj).__name__} — "
            "only stack dicts and ndarrays have a compact form")
    # record the pickle dtype so --to pickle restores the dtype contract
    # (float64 static_patches, float32 latents). Values round through
    # float32: exact for float32-origin data (patches, latents), lossy for
    # float64 content (e.g. static_patches after the float64 resize)
    dst = npz_path(dst)
    os.makedirs(os.path.dirname(os.path.abspath(dst)), exist_ok=True)
    arr = np.asarray(obj)
    if obj.dtype.kind == "f":
        arr = obj.astype(np.float32, copy=False)
        if obj.dtype.itemsize > 4 and not np.array_equal(
                arr.astype(obj.dtype), obj, equal_nan=True):
            logging.getLogger(__name__).warning(
                "%s: float%d values are not exactly representable as "
                "float32 — the compact form (and any pickle converted back "
                "from it) rounds them", src, obj.dtype.itemsize * 8)
    np.savez(dst, data=arr, pkl_dtype=np.asarray(str(obj.dtype)))
    return dst


def _compact_to_pickle(src: str, dst: str) -> str:
    with np.load(src, allow_pickle=False) as z:
        members = set(z.files)
    if members == set(STACK_MEMBERS):
        # reference stacks are float64 (extract_patches.py:262-264); exact
        # for float32-origin patch values
        data = {k: {kk: np.asarray(vv, dtype=np.float64)
                    for kk, vv in v.items()}
                for k, v in load_stack_compact(src).items()}
        save_pickle(data, dst)
        return dst
    if members not in ({"data"}, {"data", "pkl_dtype"}):
        raise ValueError(f"{src}: unrecognized npz members {members}")
    with np.load(src, allow_pickle=False) as z:
        arr = np.asarray(z["data"])
        if "pkl_dtype" in members:
            # converter-written: restore the recorded pickle dtype
            arr = arr.astype(np.dtype(str(z["pkl_dtype"])))
        elif (arr.dtype.kind == "f"
              and "static_patches" in os.path.basename(src)
              and "mask" not in os.path.basename(src)):
            # pipeline-written compact static_patches: the reference pickle
            # contract is float64 (pipeline/patch_VAE.py:166); latents and
            # masks keep their dtype
            arr = arr.astype(np.float64)
    save_pickle(arr, dst)
    return dst


def convert_storage(src: str, to: str, out: Optional[str] = None) -> str:
    """Convert one artifact between pickle and compact storage.

    ``to``: "compact" or "pickle". Detects the stack-dict vs plain-array
    layout from the content. Returns the output path.
    """
    if to == "compact":
        if not src.endswith(".pkl"):
            raise ValueError(f"expected a .pkl source, got {src}")
        return _pickle_to_compact(src, out or npz_path(src))
    if to == "pickle":
        if not src.endswith(".npz"):
            raise ValueError(f"expected a .npz source, got {src}")
        return _compact_to_pickle(src, out or pkl_path(src))
    raise ValueError(f"unknown target storage {to!r}")
