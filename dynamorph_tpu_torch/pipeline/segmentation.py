"""Semantic segmentation pipeline stage — the port of ``segmentation`` in
``dynamorph_tpu/pipeline/segmentation.py`` (reference
pipeline/segmentation.py:13-87).

For each site, ``<raw>/<site>.npy`` goes through the U-Net on the card and
``<site>_NNProbabilities.npy``, ``<site>.png`` and ``<site>_NNpred.png`` are
written beside it.
"""
from __future__ import annotations

import logging
import os
from typing import Sequence, Union

import numpy as np
import torch

from ..core.profiling import stage_timer
from ..seg.inference import predict_whole_map
from ..seg.model import Segment

log = logging.getLogger(__name__)


def segmentation(raw_folder: str, supp_folder: str, val_folder: str,
                 sites: Sequence[str], config,
                 device: Union[str, torch.device] = "cuda") -> None:
    """Semantic segmentation over sites: loads the U-Net weights
    (``segmentation_inference.weights``, a model.pt or a directory holding
    one), predicts each site's stack in ``inference_mode`` ("tiled" or
    "direct") and saves the probabilities and preview PNGs.

    A site that fails is logged ("Error in predicting site <site>", with the
    traceback) and the loop goes on, as the reference does (:76-86).
    """
    si = config.segmentation_inference
    if si.network != "UNet":
        raise NotImplementedError(
            f"segmentation model {si.network} not implemented")
    model = Segment(input_shape=(len(si.channels), si.window_size,
                                 si.window_size),
                    n_classes=si.num_classes, device=device)
    if not si.weights:
        raise ValueError("segmentation weights path must be provided")
    try:
        model.load(si.weights)
    except Exception as ex:
        log.error(ex)
        raise ValueError("Error in loading UNet weights") from ex

    for site in sites:
        site_path = os.path.join(raw_folder, f"{site}.npy")
        if not os.path.exists(site_path):
            log.info("Site not found %s", site_path)
            continue
        log.info("Predicting %s", site_path)
        try:
            with stage_timer("segmentation", site=site):
                predict_whole_map(
                    site_path, model,
                    use_channels=np.array(si.channels).astype(int),
                    n_supp=si.num_pred_rnd, mode=si.inference_mode)
        except Exception:  # per-site failure tolerance (reference :76-86)
            log.exception("Error in predicting site %s", site)
