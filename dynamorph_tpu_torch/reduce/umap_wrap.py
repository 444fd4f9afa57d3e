"""UMAP dimensionality reduction (fit-only) — the port of
``dynamorph_tpu/reduce/umap_wrap.py``.

Behavioral spec: reference run_dim_reduction.py:143-207 — grid over
n_neighbors x (a, b), save [embedding, labels] pickles + multi-panel
UMAP.png. The reference keeps UMAP fit-only (saved models from umap>=0.5
can't be pickled for transform, run_dim_reduction.py:255-256); same here.

Every fit is the native one (reduce/umap_native.py) on the caller's
device. The JAX package takes umap-learn where it imports; the port does
not, since umap-learn fits on the host whatever device was asked for.
``UMAP.png`` is drawn with numpy (reduce/scatter.py): one panel a fit, no
text.
"""
from __future__ import annotations

import logging
import os
from typing import Sequence, Union

import numpy as np
import torch

from ..core.device import resolve_device
from ..io.compact import load_array_any
from ..io.pickles import load_pickle, save_pickle
from .scatter import write_scatter_png
from .umap_native import NativeUMAP

Device = Union[str, torch.device]

log = logging.getLogger(__name__)


def fit_umap(train_data: np.ndarray, weights_dir: str, labels,
             conditions: Sequence[str], n_nbrs=(15, 50, 200),
             a_s=(1.58,), b_s=(0.9,), device: Device = "cuda") -> list:
    """Fit UMAP over a parameter grid and save embeddings + plots
    (reference run_dim_reduction.py:143-207). Returns the reducers, in
    grid order. ``conditions`` named the legend of the JAX package's
    figure; the port's figure has no text."""
    dev = resolve_device(device)
    os.makedirs(weights_dir, exist_ok=True)
    panels, reducers = [], []
    for n_nbr in n_nbrs:
        for a, b in zip(a_s, b_s):
            reducer = NativeUMAP(a=a, b=b, n_neighbors=n_nbr, device=dev)
            embedding = reducer.fit_transform(train_data)
            save_pickle([embedding, labels], os.path.join(
                weights_dir, f"umap_nbr{n_nbr}_a{a}_b{b}.pkl"))
            panels.append((embedding[:, 0], embedding[:, 1]))
            reducers.append(reducer)
            # redrawn after every fit, as the JAX package saves its figure
            write_scatter_png(os.path.join(weights_dir, "UMAP.png"), panels,
                              labels)
    return reducers


def umap_transform(input_dir: str, output_dir: str, weights_dir: str,
                   prefix: str, suffix: str = "_after") -> None:
    """Apply saved UMAP models (reference run_dim_reduction.py:94-127)."""
    os.makedirs(output_dir, exist_ok=True)
    model_fnames = [f for f in os.listdir(weights_dir)
                    if f.startswith("umap") and f.endswith(".pkl")]
    for fname in model_fnames:
        model_name = os.path.splitext(fname)[0]
        try:
            model = load_pickle(os.path.join(weights_dir, fname))
        except ModuleNotFoundError as e:
            if e.name and e.name.split(".")[0] == "umap":
                # unpickling a fitted pre-0.5 model imports the real
                # package (the native fit has no transform contract)
                raise ImportError(
                    "umap-learn is required for UMAP transform of pre-0.5 "
                    "model pickles; install it or use method='pca'") from e
            raise
        if not hasattr(model, "transform"):
            # fit_umap saves [embedding, labels] pickles under the same
            # umap* prefix (fit-only contract); skip those
            log.warning("skipping %s: not a fitted UMAP model", fname)
            continue
        dats = load_array_any(os.path.join(
            input_dir, f"{prefix}_latent_space{suffix}.pkl"))
        dats_ = model.transform(dats)
        save_pickle(dats_, os.path.join(
            output_dir, f"{prefix}_latent_space{suffix}_{model_name}.pkl"))
