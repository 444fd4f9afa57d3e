"""Dimensionality reduction pipeline stage (driver) — the port of
``dynamorph_tpu/pipeline/dim_reduction.py``.

Behavioral spec: reference run_dim_reduction.py:210-311 — pool latent vectors
across input dirs/prefixes with per-source labels, fit (PCA's SVD and the
native UMAP's kNN and SGD on ``device``) or transform with saved models
(host).
"""
from __future__ import annotations

import logging
import os
from typing import Sequence, Union

import numpy as np
import torch

from ..io.compact import load_array_any
from ..reduce.pca import fit_pca
from ..reduce.pca_model import process_pca
from ..reduce.umap_wrap import fit_umap, umap_transform

log = logging.getLogger(__name__)


def dim_reduction(method: str, input_dirs: Sequence[str],
                  output_dirs: Sequence[str], weights_dir: str,
                  config, device: Union[str, torch.device] = "cuda") -> None:
    dr = config.dim_reduction
    prefix = dr.file_name_prefixes
    conditions = dr.conditions
    fit_model = dr.fit_model

    if prefix is not None and not isinstance(prefix, list):
        prefix = [prefix]
    if prefix is None:
        raise ValueError(
            "latent space vector file name must contain a prefix: "
            "'<prefix>_latent_space.pkl'")
    fnames = [f"{p}_latent_space_after.pkl" for p in prefix]

    if method == "pca":
        fit_func, transform_func = fit_pca, process_pca
    elif method == "umap":
        fit_func, transform_func = fit_umap, umap_transform
        if not fit_model:
            raise NotImplementedError(
                "Inference mode is only supported for PCA at the moment")
    else:
        raise ValueError(
            'Dimensionality reduction method has to be "pca" or "umap"')

    if conditions is None:
        conditions = [os.path.basename(d) for d in input_dirs]
    elif not isinstance(conditions, list):
        conditions = [conditions]

    if fit_model:
        weights_output = os.path.dirname(weights_dir) \
            if os.path.isfile(weights_dir) else weights_dir
        vector_list, labels = [], []
        label = 0
        for input_dir in input_dirs:
            for f in fnames:
                # latents may be pickle or compact npz (io/compact.py)
                vec = load_array_any(os.path.join(input_dir, f))
                vector_list.append(vec)
                labels += [label] * vec.shape[0]
                label += 1
        vectors = np.concatenate(vector_list, axis=0)
        fit_func(vectors, weights_output, labels=labels,
                 conditions=conditions, device=device)
        if method == "umap":
            return  # fit-only (see reduce/umap_wrap.py)
    else:
        weights_input = os.path.dirname(weights_dir) \
            if os.path.isfile(weights_dir) else weights_dir
        for input_d, output_d in zip(input_dirs, output_dirs):
            for p in prefix:
                log.info("Transforming latent vectors for prefix %s in %s",
                         p, input_d)
                transform_func(input_dir=input_d, output_dir=output_d,
                               weights_dir=weights_input, prefix=p)
