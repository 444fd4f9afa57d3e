"""Triplet mining losses — the port of ``dynamorph_tpu/models/losses.py``
(reference HiddenStateExtractor/losses.py: AllTripletMiner :74-161,
HardNegativeTripletMiner :164-263).

Stock PyTorch ops (XLA code in the JAX package). The all-triplet miner
builds (B, B, B) tensors: at 768 patches a step each one is 453 M elements
(1.8 GB in fp32), so its mask stays boolean (0.45 GB) and the hinge is
formed in place, one fp32 cube alive at a time in the forward.
"""
from __future__ import annotations

import torch

from ..core.device import fp32_strict


def pairwise_dist(embeddings: torch.Tensor) -> torch.Tensor:
    """Squared euclidean pairwise distances, clamped at 0
    (reference losses.py:29-50), from the (B, D) embeddings' Gram matrix in
    full fp32 (no TF32: the JAX package runs it at HIGHEST)."""
    with fp32_strict():
        dot = embeddings @ embeddings.T
    sq = torch.diagonal(dot)
    d = sq[None, :] - 2.0 * dot + sq[:, None]
    return torch.clamp(d, min=0.0)


def _triplet_mask(ids: torch.Tensor) -> torch.Tensor:
    """(B, B, B) boolean mask of valid (anchor, positive, negative) index
    triplets: three distinct indices, the positive of the anchor's label,
    the negative of another (reference losses.py:94-121)."""
    n = ids.shape[0]
    not_eq = ~torch.eye(n, dtype=torch.bool, device=ids.device)
    distinct = not_eq[:, :, None] & not_eq[:, None, :] & not_eq[None, :, :]
    ids_eq = ids[None, :] == ids[:, None]
    return distinct & ids_eq[:, :, None] & ~ids_eq[:, None, :]


def _as_ids(ids, device) -> torch.Tensor:
    return torch.as_tensor(ids, device=device)


class AllTripletMiner:
    """Loss over all valid triplets: the mean hinge ``max(d_ap - d_an +
    margin, 0)`` over the triplets where it is positive, and the fraction
    of valid triplets that are (reference losses.py:74-161). Returns
    (loss, fraction_positive_triplets)."""

    def __init__(self, margin: float = 0.5):
        self.margin = margin

    def __call__(self, ids, embeddings: torch.Tensor):
        ids = _as_ids(ids, embeddings.device)
        d = pairwise_dist(embeddings)
        mask = _triplet_mask(ids)
        hinge = d[:, :, None] - d[:, None, :]
        hinge.add_(self.margin)
        # where() keeps only the mask for its backward, so the cube above
        # is freed here; relu_ keeps its own output
        loss = torch.where(mask, hinge, 0.0)
        del hinge
        loss.relu_()
        # counts in integers: a float32 sum of ones is inexact past 2**24
        n_pos = torch.count_nonzero(loss > 1e-16).to(torch.float32)
        n_val = torch.count_nonzero(mask).to(torch.float32)
        f_pos = n_pos / (n_val + 1e-16)
        return torch.sum(loss) / (n_pos + 1e-16), f_pos


class HardNegativeTripletMiner:
    """Hardest-positive against mean-negative triplet loss (reference
    losses.py:164-263). Returns (loss, None): this miner has no
    positive-fraction metric."""

    def __init__(self, margin: float = 0.5):
        self.margin = margin

    def __call__(self, ids, embeddings: torch.Tensor):
        ids = _as_ids(ids, embeddings.device)
        d = pairwise_dist(embeddings)
        n = ids.shape[0]
        eye = torch.eye(n, dtype=torch.bool, device=ids.device)
        mask_anc_pos = ~eye & (ids[None, :] == ids[:, None])
        pos_dist = torch.max(mask_anc_pos.to(d.dtype) * d, dim=1,
                             keepdim=True).values
        mask_anc_neg = ids[None, :] != ids[:, None]
        max_d = torch.max(d, dim=1, keepdim=True).values
        neg = d + max_d * (1.0 - mask_anc_neg.to(d.dtype))
        neg_dist = torch.mean(neg, dim=1)
        # (B, 1) - (B,) broadcasts to (B, B), as in the reference (:263)
        loss = torch.clamp(pos_dist - neg_dist + self.margin, min=0.0)
        return torch.mean(loss), None
