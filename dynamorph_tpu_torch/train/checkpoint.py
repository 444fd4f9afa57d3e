"""Training checkpoints in the reference's format.

``<dir>/model.pt`` is the model's ``state_dict`` under the reference's names
(reference pipeline/train_utils.py:54-60, run_training.py:542-545), so
``run_vae -m process`` with ``weights: <dir>`` loads it
(``pipeline.patch_vae.resolve_latent_weights``). Beside it,
``<dir>/train_state.pt`` holds the optimizer state and the epoch, which
``resume`` reads. The JAX package writes an orbax directory instead
(dynamorph_tpu/train/checkpoint.py); the port neither writes nor reads one.
"""
from __future__ import annotations

import os
from typing import Optional

import torch

from ..models.jax_import import load_reference_checkpoint

MODEL_FILE = "model.pt"
TRAIN_STATE_FILE = "train_state.pt"


def _save_atomic(obj, path: str) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)   # a reader never sees a half-written file


def save_checkpoint(path: str, model: torch.nn.Module,
                    optimizer: Optional[torch.optim.Optimizer] = None,
                    epoch: Optional[int] = None) -> None:
    """Write ``<path>/model.pt`` (CPU tensors) and, with an optimizer,
    ``<path>/train_state.pt``."""
    os.makedirs(path, exist_ok=True)
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    _save_atomic(state, os.path.join(path, MODEL_FILE))
    if optimizer is not None:
        _save_atomic({"optimizer": optimizer.state_dict(), "epoch": epoch},
                     os.path.join(path, TRAIN_STATE_FILE))


def has_checkpoint(path: str) -> bool:
    return os.path.exists(os.path.join(path, MODEL_FILE))


def restore_checkpoint(path: str, model: torch.nn.Module,
                       optimizer: Optional[torch.optim.Optimizer] = None
                       ) -> Optional[int]:
    """Load ``<path>/model.pt`` into ``model`` (strict) and, where it
    exists, the optimizer state. Returns the saved epoch, or None."""
    model.load_state_dict(
        load_reference_checkpoint(os.path.join(path, MODEL_FILE)),
        strict=True)
    state_path = os.path.join(path, TRAIN_STATE_FILE)
    if optimizer is None or not os.path.exists(state_path):
        return None
    state = torch.load(state_path, map_location="cpu", weights_only=True)
    optimizer.load_state_dict(state["optimizer"])
    return state["epoch"]
