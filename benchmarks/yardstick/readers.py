"""Arithmetic that several metrics' readers share. A reader returns None
where the run holds nothing for it to read."""
from __future__ import annotations

from typing import Optional

import numpy as np

from . import roofline
from .trace import family_seconds


def traced(ctx) -> list:
    return [t for t in (ctx.traces or []) if t is not None]


def idle_share(ctx) -> Optional[float]:
    """% of the traced window in which no operation ran on the card, the
    mean over the cards."""
    tr = traced(ctx)
    if not tr:
        return None
    return float(np.mean([100.0 * (1.0 - t["busy_s"] / t["window_s"])
                          for t in tr]))


def mfu(ctx) -> float:
    """% of the cards' fp32 peak that the model's operations (counted from
    its shapes, ``roofline.epoch_flops``) over the window's wall time
    reach."""
    flops = ctx.epochs * roofline.epoch_flops(
        ctx.cfg, ctx.train_batches, ctx.val_batches,
        ctx.traffic["patch_size"])
    return 100.0 * flops / ctx.window_s / (
        ctx.chips * roofline.FP32_FLOP_PER_S)


def family_ms_per_step(ctx, families) -> Optional[float]:
    """Rank 0's device ms in the kernel ``families`` per training step of
    the traced window (its validation steps' kernels included)."""
    tr = traced(ctx)
    if not tr:
        return None
    fam = family_seconds(tr[0])
    steps = ctx.epochs * len(ctx.train_batches)
    return 1e3 * sum(fam.get(f, 0.0) for f in families) / steps


def kernel_roofline(ctx, key: str, bound_of) -> Optional[float]:
    """% of rank 0's device time in kernels named with ``key`` that the
    least time of their work (``bound_of(rows)`` seconds for a training
    batch of ``rows`` rows on one rank, one launch a step) takes."""
    tr = traced(ctx)
    if not tr:
        return None
    hits = [v for k, v in tr[0]["kernels"].items() if key in k]
    count = sum(c for c, _ in hits)
    seconds = sum(s for _, s in hits)
    if not count or count != ctx.epochs * len(ctx.train_batches):
        return None
    least = ctx.epochs * sum(bound_of(b // ctx.ranks)
                             for b in ctx.train_batches)
    return 100.0 * least / seconds


def rate(ctx) -> float:
    """Training patches (of every rank) stepped per second of the
    window."""
    return ctx.epochs * sum(ctx.train_batches) / ctx.window_s


def vq_indices_roofline(ctx) -> Optional[float]:
    """``kernel_roofline`` of ``vq_indices``: one launch a training step over
    the batch's latent grid."""
    h, w = roofline.latent_grid(ctx.cfg, ctx.traffic["patch_size"])
    d, k = ctx.cfg["num_hiddens"], ctx.cfg["num_embeddings"]
    return kernel_roofline(
        ctx, "vq_indices",
        lambda rows: roofline.indices_bound(rows * h * w, d, k)[0])
