"""VQ-VAE family training (the reference `train` entry, run_training.py:
455-551) and triplet training (`train_with_loader`, :554-627): the port of
``dynamorph_tpu/train/trainer.py`` for one process and one device.

Batches stay trajectory-contiguous when a relation matrix is used
(shuffle_data=False, reference run_training.py:471-472); the relation block
for each batch is sliced from the csr matrix on the host, in a prefetch
thread, while the device runs the previous step.
"""
from __future__ import annotations

import os
import warnings
from typing import Optional, Union

import numpy as np
import torch

from ..core.device import resolve_device, upload
from ..io.prefetch import Prefetcher
from . import data as data_utils
from .checkpoint import has_checkpoint, restore_checkpoint, save_checkpoint
from .metrics import MetricsWriter
from .steps import make_eval_step, make_train_step, make_triplet_steps
from .triplet_data import TripletDataset, triplet_batches

# train_vqvae keeps the patch dataset (and the uint8 mask) on the device
# across epochs up to this many bytes; above it, batches stream from the
# host every step
_DEVICE_RESIDENT_BUDGET = 4 * 1024**3


class EarlyStopping:
    """Stop when val loss hasn't improved for `patience` epochs; checkpoint on
    improvement (reference pipeline/train_utils.py:8-60)."""

    def __init__(self, patience: int = 7, delta: float = 0.0,
                 path: str = "checkpoint", verbose: bool = False):
        self.patience = patience
        self.delta = delta
        self.path = path
        self.verbose = verbose
        self.counter = 0
        self.best_score = None
        self.early_stop = False
        self.val_loss_min = np.inf

    def __call__(self, val_loss: float, model, optimizer=None,
                 epoch: Optional[int] = None) -> None:
        score = -val_loss
        if self.best_score is None:
            self.best_score = score
            self._save(val_loss, model, optimizer, epoch)
        elif score < self.best_score + self.delta:
            self.counter += 1
            if self.verbose:
                print(f"EarlyStopping counter: {self.counter} / {self.patience}")
            if self.counter >= self.patience:
                self.early_stop = True
        else:
            self.best_score = score
            self._save(val_loss, model, optimizer, epoch)
            self.counter = 0

    def _save(self, val_loss: float, model, optimizer, epoch) -> None:
        if self.verbose:
            print(f"Validation loss decreased ({self.val_loss_min:.6f} -> "
                  f"{val_loss:.6f}). Saving model ...")
        save_checkpoint(self.path, model, optimizer, epoch)
        self.val_loss_min = val_loss


def train_vqvae(model, dataset: np.ndarray, output_dir: str,
                relation_mat=None, mask: Optional[np.ndarray] = None,
                n_epochs: int = 10, lr: float = 1e-3, batch_size: int = 16,
                shuffle_data: bool = False, transform: bool = False,
                val_split_ratio: Optional[float] = 0.15,
                patience: Optional[int] = 20, seed: int = 0,
                save_every_epoch: bool = False, resume: bool = False,
                device: Union[str, torch.device] = "cuda"):
    """Train a VQ-VAE family model (VQ-VAE z16/z32, VAE, IWAE, AAE) in
    place. Returns (model, history).

    ``model`` starts from the weights it holds. The best epoch's weights go
    to ``<output_dir>/model.pt`` (reference names) with the optimizer state
    and epoch beside it (``train/checkpoint.py``); ``resume=True`` restores
    those and continues at the next epoch. ``save_every_epoch`` also writes
    ``<output_dir>/model_epoch<e>/model.pt``.

    Args mirror the reference `train` (run_training.py:455-486): Adam(0.9,
    0.999, eps 1e-8; the update of ``optax.adam``), per-epoch train/val loss
    averaging, TensorBoard scalars and ``metrics.jsonl``, early stopping on
    the val loss. ``device`` is the card unless the caller passes "cpu";
    without a card the call raises. One ``torch.Generator`` on the device,
    seeded with ``seed``, draws the augmentation and the VAE and IWAE
    noise. The AAE trains through ``apply`` with no adversarial term, as
    in the JAX package.
    """
    if val_split_ratio is not None and not 0 < val_split_ratio < 1:
        raise ValueError(f"val_split_ratio {val_split_ratio} not in (0, 1)")
    dev = resolve_device(device)
    os.makedirs(output_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    generator = torch.Generator(device=dev).manual_seed(seed)

    model.to(dev)
    optimizer = torch.optim.Adam(model.parameters(), lr=lr,
                                 betas=(0.9, 0.999), eps=1e-8)
    start_epoch = 0
    if resume and has_checkpoint(output_dir):
        epoch = restore_checkpoint(output_dir, model, optimizer)
        start_epoch = -1 if epoch is None else epoch
        start_epoch += 1
        print(f"Resuming from {output_dir} at epoch {start_epoch}")
    train_step = make_train_step(model, optimizer, augment=transform,
                                 generator=generator)
    eval_step = make_eval_step(model, generator=generator)

    train_ids, val_ids = data_utils.split_data_ids(
        len(dataset), val_split_ratio, shuffle_data, rng)
    n_batches = int(np.ceil(len(train_ids) / batch_size))
    n_val_batches = int(np.ceil(len(val_ids) / batch_size))

    writer = MetricsWriter(output_dir)
    early = EarlyStopping(patience=patience or 10 ** 9, path=output_dir,
                          verbose=True)
    history = []

    # Device-resident feed: the patches (and the uint8 mask, transformed
    # once by slice_mask over the whole set, so the two feeds cannot
    # diverge) upload once, and each batch is an int32 index gather on the
    # device; only the uint8 relation blocks travel per step. The gate
    # counts both, so a dataset that barely fits does not run out once the
    # mask uploads too.
    resident_bytes = dataset.nbytes + (
        0 if mask is None else len(mask) * int(np.prod(mask.shape[2:])))
    resident = resident_bytes <= _DEVICE_RESIDENT_BUDGET
    if resident:
        dataset_src = torch.from_numpy(np.ascontiguousarray(dataset)).to(dev)
        mask_src = None if mask is None else torch.from_numpy(
            data_utils.slice_mask(mask, np.arange(len(mask)))).to(dev)

    def load_batch(bids):
        """Relation slice and the batch on the device (a gather when
        resident, a host copy and upload when streamed). Runs in a prefetch
        thread so the next batch's feed overlaps the current step."""
        rel = data_utils.slice_relation_mat(relation_mat, bids)
        rel = None if rel is None else torch.from_numpy(rel).to(dev)
        if resident:
            bidx = torch.from_numpy(np.asarray(bids, np.int32)).to(dev)
            batch = torch.index_select(dataset_src, 0, bidx)
            bmask = None if mask_src is None else \
                torch.index_select(mask_src, 0, bidx)
        else:
            batch = torch.from_numpy(np.ascontiguousarray(dataset[bids])).to(dev)
            bmask = data_utils.slice_mask(mask, bids)
            bmask = None if bmask is None else torch.from_numpy(bmask).to(dev)
        return batch, rel, bmask

    def run_epoch(ids, n_b, training):
        # loss sums stay on the device; one host sync per epoch
        totals = None
        feed = Prefetcher([ids[i * batch_size: (i + 1) * batch_size]
                           for i in range(n_b)], load_batch, depth=2)
        step = train_step if training else eval_step
        for _, (batch, rel, bmask) in feed:
            losses = step(batch, rel, bmask)
            totals = losses if totals is None else \
                {k: totals[k] + v for k, v in losses.items()}
        if totals is None:
            return {}
        keys = sorted(totals)
        sums = torch.stack([totals[k] for k in keys]).cpu().tolist()
        return {k: s / n_b for k, s in zip(keys, sums)}

    for epoch in range(start_epoch, n_epochs):
        train_losses = run_epoch(train_ids, n_batches, True)
        val_losses = run_epoch(val_ids, n_val_batches, False)
        writer.write("Loss", train_losses, epoch)
        writer.write("Val loss", val_losses, epoch)
        history.append({"epoch": epoch, "train": train_losses,
                        "val": val_losses})
        if save_every_epoch:
            # legacy per-epoch checkpoints (reference vq_vae_supp.py:385)
            save_checkpoint(os.path.join(output_dir, f"model_epoch{epoch}"),
                            model)
        if not val_losses:
            # no val batch: early-stop on the train loss, which rarely
            # plateaus, so runs tend to go the full n_epochs
            if epoch == start_epoch:
                warnings.warn(
                    "validation split has no batch; early stopping will "
                    "monitor the TRAIN loss (patience may never trigger)")
            val_losses = train_losses
        early(val_losses["total_loss"], model, optimizer, epoch)
        if early.early_stop:
            print("Early stopping")
            break
        if shuffle_data and epoch < n_epochs - 1:
            # reshuffle for the NEXT epoch only, after the early-stop check
            rng.shuffle(train_ids)
    writer.close()
    return model, history


def train_triplet(model, train_set: TripletDataset, val_set: TripletDataset,
                  output_dir: str, n_epochs: int = 10, lr: float = 1e-3,
                  batch_size: int = 192, patience: Optional[int] = 20,
                  earlystop_metric: str = "positive_triplet",
                  retrain: bool = False, log_step_offset: int = 0,
                  seed: int = 0, device: Union[str, torch.device] = "cuda"):
    """Triplet-loss training with positive-set sampling (the reference
    ``train_with_loader``, run_training.py:554-627;
    dynamorph_tpu/train/trainer.py:415-559). Returns (model, history).

    ``batch_size`` counts anchors: each yields ``n_sample`` patches
    (``train/triplet_data.py``), and the flattened batch runs through one
    forward, miner, backward and Adam step. The epochs run from
    ``log_step_offset`` to ``n_epochs``; the train split is shuffled with
    ``np.random.RandomState(seed)``, and the datasets draw their own
    augmentation and positives. A ``model.pt`` already in ``output_dir``
    is loaded first (strict) unless ``retrain``. Early stopping monitors
    the val ``earlystop_metric`` (the train one without val batches, and
    ``total_loss`` where the metric is missing, as for the hard-negative
    miner), and each improvement writes ``<output_dir>/model.pt``.
    Each batch is built on the host while the device runs the previous
    step; loss sums stay on the device until the epoch ends.
    """
    dev = resolve_device(device)
    os.makedirs(output_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    model.to(dev)
    if has_checkpoint(output_dir) and not retrain:
        print(f"Found previously saved model state {output_dir}. "
              "Continue training...")
        restore_checkpoint(output_dir, model)
    optimizer = torch.optim.Adam(model.parameters(), lr=lr,
                                 betas=(0.9, 0.999), eps=1e-8)
    train_step, eval_step = make_triplet_steps(model, optimizer)

    writer = MetricsWriter(output_dir)
    early = EarlyStopping(patience=patience or 10 ** 9, path=output_dir,
                          verbose=True)
    history = []
    warned_fallback = False
    for epoch in range(log_step_offset, n_epochs):
        means = {}
        for training, dataset in ((True, train_set), (False, val_set)):
            step = train_step if training else eval_step
            totals, count = None, 0
            for labels, data in triplet_batches(dataset, batch_size,
                                                shuffle=training, rng=rng):
                losses = step(upload(np.asarray(data, np.float32), dev),
                              upload(np.asarray(labels), dev))
                totals = losses if totals is None else \
                    {k: totals[k] + v for k, v in losses.items()}
                count += 1
            if totals is not None:
                keys = sorted(totals)
                sums = torch.stack([totals[k] for k in keys]).cpu().tolist()
                totals = {k: v / count for k, v in zip(keys, sums)}
            means[training] = totals or {}
        train_losses, val_losses = means[True], means[False]
        writer.write("Loss", train_losses, epoch)
        writer.write("Val loss", val_losses, epoch)
        history.append({"epoch": epoch, "train": train_losses,
                        "val": val_losses})
        if not train_losses:
            raise ValueError(
                f"no training batches ran: the dataset ({len(train_set)} "
                f"anchors) must cover at least one batch of {batch_size} "
                "anchors")
        monitored = val_losses or train_losses
        metric = earlystop_metric if earlystop_metric in monitored \
            else "total_loss"
        if (not val_losses or metric != earlystop_metric) \
                and not warned_fallback:
            warnings.warn(
                f"early stopping monitors "
                f"{'val' if val_losses else 'TRAIN'} '{metric}' "
                f"(requested '{earlystop_metric}')")
            warned_fallback = True
        early(monitored[metric], model)
        if early.early_stop:
            print("Early stopping")
            break
    writer.close()
    return model, history
