"""Reading the program's own record of the window's trainer call: the
spans and counters that ``train_vqvae`` keeps while a ``torch.profiler``
records (``dynamorph_tpu_torch.core.profiling.last_record``). The
window's call is the program's last trainer call in this process, since
the plain reference calls nothing of the program.

A reader returns None where the record cannot be the window's: over
ranks (each rank's record stays in its own process), with no record (a
program that keeps none), on the CPU (drained time means a card with
nothing queued), or where its step counts are not the window's.
"""
from __future__ import annotations

from typing import Dict, Optional


def window_record(ctx) -> Optional[Dict]:
    if ctx.ranks > 1:
        return None
    try:
        from dynamorph_tpu_torch.core.profiling import last_record
    except ImportError:
        return None
    rec = last_record("train_vqvae")
    if not rec or rec.get("device") != "cuda":
        return None
    counters = rec.get("counters", {})
    if counters.get("train.steps") != ctx.epochs * len(ctx.train_batches) \
            or counters.get("train.val_steps", 0) != \
            ctx.epochs * len(ctx.val_batches):
        return None
    return rec


def _seconds(rec: Dict, span: str) -> Optional[float]:
    hit = rec["spans"].get(span)
    return None if hit is None else hit[1]


def drained_share(ctx) -> Optional[float]:
    """% of the window's call in which the host worked with the card
    drained: from each pass's loss sync to the next pass's first step."""
    rec = window_record(ctx)
    if rec is None:
        return None
    drained = _seconds(rec, "train.drained")
    call = _seconds(rec, "train.call")
    if drained is None or not call:
        return None
    return 100.0 * drained / call


def feed_wait_ms(ctx) -> Optional[float]:
    """Host ms a step (training and validation) that the main loop waited
    on the prefetch thread's next batch."""
    rec = window_record(ctx)
    if rec is None:
        return None
    wait = _seconds(rec, "train.feed_wait")
    steps = rec["counters"]["train.steps"] + \
        rec["counters"].get("train.val_steps", 0)
    return None if wait is None else 1e3 * wait / steps


def upload_ms(ctx) -> Optional[float]:
    """Host ms of the call's resident upload of the training set (None
    where the feed streams from the host)."""
    rec = window_record(ctx)
    if rec is None:
        return None
    upload = _seconds(rec, "train.upload")
    return None if upload is None else 1e3 * upload
