"""The trajectory-sharded time-matching loss of data-parallel training — the
port of ``dynamorph_tpu/train/sharded_loss.py``.

The time-matching loss is a dense (B, B) pairwise-latent-distance matrix over
the batch (reference HiddenStateExtractor/vae.py:322-336). Under data
parallelism that would gather every rank's latents, (B, L) with L = 32 x 32
x 64 at the z32 production widths. Instead whole trajectories go to one
rank each (``pack_trajectories``), so the relation matrix is block-diagonal
over the ranks:

- each rank's (b, b) diagonal block carries the full relation semantics
  (w_a / w_t / w_n and the hinge) and is computed locally;
- every cross-rank pair is a negative, whose term max(w_n * sim + margin, 0)
  needs distances only: a ring of ``world - 1`` steps passes each rank's
  latents on to rank ``r + 1`` (``core.mesh.ring_shift``, whose backward
  sends the gradient back the other way), one (b, b) block of distances
  against the resident shard a step. No (B, L) gather exists.

The sum over ranks over B^2 equals the dense loss whenever no trajectory
straddles two ranks; a straddling trajectory's cross-rank pairs count as
negatives, as the reference's minibatch boundaries do.

``trajectory_ids_from_relations`` labels connected components with a
union-find of its own on the host (as the port's other host solvers are its
own), not scipy's ``connected_components``; the labels are numbered in the
order of each component's first sample, as scipy numbers them.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..core.mesh import all_reduce_sum, current_comm, ring_shift


def cross_sq_dist_mean(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(m, L), (k, L) -> (m, k) of mean_l (a_i - b_j)^2 in matmul form,
    clamped at 0. fp32 under the caller's ``fp32_strict`` on the card; the
    JAX package takes DEFAULT precision (fp32 on the CPU)."""
    l = a.shape[1]
    sa = torch.sum(a * a, dim=1)
    sb = torch.sum(b * b, dim=1)
    d = sa[:, None] + sb[None, :] - 2.0 * (a @ b.T)
    return torch.clamp(d, min=0.0) / l


def make_traj_sharded_tm_loss(comm=None):
    """A time-matching loss with the dense loss's signature ``(z_flat, rel,
    w_a, w_t, w_n, margin) -> scalar`` for the models' ``tm_loss_fn``
    field. ``z_flat`` is this rank's (b, L) shard and ``rel`` its (b, b)
    diagonal relation block (``blockdiag_relations``); the value is the
    global batch's loss, the same on every rank. ``comm`` defaults to the
    step's ``current_comm()`` (one rank without one)."""

    def loss(z_flat, rel_block, w_a, w_t, w_n, margin):
        c = comm if comm is not None else current_comm()
        n = 1 if c is None else c.world
        b_total = z_flat.shape[0] * n
        rel = torch.as_tensor(rel_block).to(z_flat.device).to(torch.float32)
        sim = cross_sq_dist_mean(z_flat, z_flat)
        w = torch.where(rel == 2, w_a, torch.where(rel == 1, w_t, w_n))
        val = sim * w
        val = torch.where(rel == 0, torch.clamp(val + margin, min=0.0), val)
        total = torch.sum(val)
        z_rot = z_flat
        for _ in range(n - 1):
            # every cross-rank pair is a negative
            z_rot = ring_shift(z_rot, c)
            total = total + torch.sum(torch.clamp(
                cross_sq_dist_mean(z_flat, z_rot) * w_n + margin, min=0.0))
        if c is not None:
            total = all_reduce_sum(total, c)
        return total / (b_total * b_total)

    return loss


def trajectory_ids_from_relations(relation_mat, n: int) -> np.ndarray:
    """Per-sample trajectory id from a (sparse or dense) relation matrix:
    the connected components of relation >= 1, numbered in the order of
    their first sample."""
    if relation_mat is None:
        return np.arange(n)
    if hasattr(relation_mat, "tocoo"):
        coo = relation_mat.tocoo()
        keep = coo.data >= 1
        rows, cols = coo.row[keep], coo.col[keep]
    else:
        rows, cols = np.nonzero(np.asarray(relation_mat) >= 1)
    parent = np.arange(n)

    def root(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    for i, j in zip(rows.tolist(), cols.tolist()):
        ri, rj = root(i), root(j)
        if ri != rj:
            parent[max(ri, rj)] = min(ri, rj)
    roots = np.array([root(i) for i in range(n)])
    # each root is its component's smallest sample: number them in order
    _, labels = np.unique(roots, return_inverse=True)
    return labels.astype(np.int32)


def pack_trajectories(bids: Sequence[int], traj_ids: np.ndarray,
                      n_shards: int) -> np.ndarray:
    """Permute a batch's sample ids so whole trajectories land in one
    rank's chunk (first-fit-decreasing into ``n_shards`` equal chunks).

    Returns the permuted ids (length kept, each chunk exactly
    ``len(bids) / n_shards``). A trajectory larger than a chunk, or one
    that no chunk has room for, is split greedily; its cross-rank pairs
    count as negatives in the sharded loss."""
    bids = np.asarray(bids)
    b = len(bids)
    if b % n_shards:
        raise ValueError(f"a batch of {b} does not split into {n_shards} "
                         f"equal rank shards")
    cap = b // n_shards
    groups: dict = {}
    for pos, sid in enumerate(bids):
        groups.setdefault(traj_ids[sid], []).append(pos)
    order = sorted(groups.values(), key=len, reverse=True)
    bins = [[] for _ in range(n_shards)]
    spill = []
    for g in order:
        for bin_ in bins:
            if len(bin_) + len(g) <= cap:
                bin_.extend(g)
                break
        else:
            spill.extend(g)
    for item in spill:            # fill the remaining room greedily
        for bin_ in bins:
            if len(bin_) < cap:
                bin_.append(item)
                break
    return np.concatenate([bids[bin_] for bin_ in bins])


def blockdiag_relations(relation_mat, bids, n_shards: int) -> np.ndarray:
    """The diagonal relation blocks of a (packed) batch as (B, B / n) uint8:
    rows ``[k b, (k + 1) b)`` hold rank k's (b, b) block. A rank sends
    ``n`` times fewer bytes than the dense (B, B) block."""
    bids = np.asarray(bids)
    b = len(bids) // n_shards
    blocks = []
    for k in range(n_shards):
        ids = bids[k * b:(k + 1) * b]
        block = relation_mat[ids][:, ids]
        if hasattr(block, "todense"):
            block = block.todense()
        blocks.append(np.asarray(block))
    return np.concatenate(blocks, axis=0).astype(np.uint8)
