"""VQ-VAE family training (the reference `train` entry, run_training.py:
455-551) and triplet training (`train_with_loader`, :554-627): the port of
``dynamorph_tpu/train/trainer.py``, on one device, or data-parallel with
one device a rank inside a process group (``core.mesh.init_multihost``).

Batches stay trajectory-contiguous when a relation matrix is used
(shuffle_data=False, reference run_training.py:471-472); the relation block
for each batch is sliced from the csr matrix on the host, in a prefetch
thread, while the device runs the previous step.

Data-parallel runs (dynamorph_tpu/train/trainer.py:82-330, :420-560):
every rank calls the trainer with the same arguments and seed (the host
data is replicated), and rank 0's weights are broadcast first. Each step
takes the global batch: every rank uploads only its own equal shard of it
(the JAX package's ``put_global``) and the step (``train/steps.py``) makes
the losses, batch norm and miner the global batch's, so the histories are
the same on every rank and early stopping agrees. The batch must split
evenly over the ranks, and partial batches are dropped. Rank 0 alone
writes ``model.pt``, the metrics and the per-epoch checkpoints; the other
ranks wait at a barrier after each write. ``resume`` reads on every rank.
"""
from __future__ import annotations

import os
import warnings
from typing import Optional, Union

import numpy as np
import torch

from ..core import mesh, profiling
from ..core.device import resolve_device, upload
from ..io.prefetch import Prefetcher
from ..ops.batch_norm import batch_norm_train
from . import data as data_utils
from . import sharded_loss as SL
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
    improvement (reference pipeline/train_utils.py:8-60), each checkpoint a
    span of ``record``."""

    def __init__(self, patience: int = 7, delta: float = 0.0,
                 path: str = "checkpoint", verbose: bool = False,
                 record: profiling.Record = profiling.OFF):
        self.patience = patience
        self.delta = delta
        self.path = path
        self.verbose = verbose and mesh.is_main_process()   # rank 0 prints
        self.record = record
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
        _save_on_main(self.path, model, optimizer, epoch, self.record)
        self.val_loss_min = val_loss


def _save_on_main(path: str, model, optimizer=None, epoch=None,
                  record: profiling.Record = profiling.OFF) -> None:
    """``save_checkpoint`` by rank 0 alone; in a process group every rank
    leaves once the file is written. ``record`` holds the span
    ``train.checkpoint`` and counts ``train.checkpoints``."""
    with record.span("train.checkpoint"):
        if mesh.is_main_process():
            save_checkpoint(path, model, optimizer, epoch)
            record.count("train.checkpoints")
        mesh.barrier("checkpoint")


def _data_parallel_comm():
    """The communicator of a process group, or None for one process."""
    return mesh.ProcessGroupComm() if mesh.is_distributed() else None


def _check_batch_splits(rows: int, world: int, what: str) -> None:
    """The port's message for a batch that does not split over the ranks.
    The JAX package's says the batch "must divide the mesh", the wrong way
    round (dynamorph_tpu/train/trainer.py:150-153), and its train_triplet
    drops every batch and blames the dataset (:485-496, :530-539)."""
    if rows % world:
        raise ValueError(
            f"{what} {rows} does not split evenly over the {world} ranks of "
            f"the process group: it must be a multiple of the world size "
            f"{world} (multi-process runs also drop partial batches)")


class _PassEdges:
    """The spans of ``train_vqvae`` whose ends lie at the edges of its
    passes, not around a block. ``train.epoch`` runs from the issue of the
    epoch's first training step to the next epoch's, or to the call's end,
    and then appends its spans and counters to the timing log.
    ``train.drained`` runs from a pass's loss sync (``_mean_losses``, which
    leaves the card with no queued work) to the next pass's first step, or
    to the call's end. Both nest in ``train.call``, and a drained span in
    its epoch's."""

    def __init__(self, record: profiling.Record):
        self.record = record
        self.epoch = self.drained = None

    def _open(self, name: str):
        span = self.record.span(name)
        span.__enter__()
        return span

    def first_step(self, epoch: Optional[int]) -> None:
        """Before a pass's first step; ``epoch`` for a training pass."""
        self._end_drained()
        if epoch is not None:
            self._end_epoch()
            self.epoch = (epoch, self.record.snapshot(),
                          self._open("train.epoch"))

    def synced(self) -> None:
        """After a pass's loss sync (a pass with no batch has none, and
        leaves an open drained span open)."""
        if self.drained is None:
            self.drained = self._open("train.drained")

    def close(self) -> None:
        self._end_drained()
        self._end_epoch()

    def _end_drained(self) -> None:
        if self.drained is not None:
            self.drained.__exit__(None, None, None)
            self.drained = None

    def _end_epoch(self) -> None:
        if self.epoch is None:
            return
        epoch, before, span = self.epoch
        self.epoch = None
        span.__exit__(None, None, None)
        if self.record.log_path:
            part = self.record.totals(since=before)
            self.record.log("train.epoch", part["spans"]["train.epoch"][1],
                            epoch=epoch, **part)


def _mean_losses(totals, count: int):
    """Device loss sums -> host means (one sync)."""
    if totals is None:
        return {}
    keys = sorted(totals)
    sums = torch.stack([totals[k] for k in keys]).cpu().tolist()
    return {k: v / count for k, v in zip(keys, sums)}


def train_vqvae(model, dataset: np.ndarray, output_dir: str,
                relation_mat=None, mask: Optional[np.ndarray] = None,
                n_epochs: int = 10, lr: float = 1e-3, batch_size: int = 16,
                shuffle_data: bool = False, transform: bool = False,
                val_split_ratio: Optional[float] = 0.15,
                patience: Optional[int] = 20, seed: int = 0,
                save_every_epoch: bool = False, resume: bool = False,
                traj_sharded_loss: bool = False,
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

    In a process group (see the module docstring) ``batch_size`` is the
    global batch. ``traj_sharded_loss=True`` (needs a process group and
    ``relation_mat``) packs whole trajectories onto the ranks each batch
    (``sharded_loss.pack_trajectories``) and runs the time-matching loss
    block-diagonally with the ring for the cross-rank negatives
    (``sharded_loss.make_traj_sharded_tm_loss``): no rank gathers the
    latents, and each receives its (b, b) relation block only. It needs at
    least one full batch. Without it the dense loss runs on the gathered
    latents and the global (B, B) block.

    Tracing (``core/profiling.py``): a call made while a
    ``torch.profiler`` records on the calling thread, or while
    ``DYNAMORPH_TIMING_LOG`` names a JSONL file, records these spans, each
    a ``record_function`` range of that name in the profiler's trace and a
    host-clock sum of count and seconds: ``train.call`` (the whole call),
    ``train.upload`` (the resident upload), ``train.epoch`` (from an
    epoch's first training step to the next epoch's, or to the call's
    end), ``train.feed_wait`` (the loop waiting on the prefetch thread, a
    batch), ``train.load`` (``load_batch`` in the prefetch thread, which a
    default profiler does not follow), ``train.drained`` (from a pass's
    loss sync, which leaves the card idle, to the next pass's first step
    or the call's end: the metrics write, checkpoint, flag gather and the
    next pass's first batch) and ``train.checkpoint`` (a checkpoint's save
    and barrier); and these counters: ``train.steps``,
    ``train.val_steps``, ``train.h2d_bytes`` (what the call copies to the
    device), ``train.checkpoints``, and ``train.bn_kernel`` and
    ``train.bn_fallback`` (the training-mode batch norms of the call that
    ran the port's kernels, on the card, and that ran ``F.batch_norm``, on
    the CPU: ``ops.batch_norm.batch_norm_train``'s counters over the call,
    which count every thread's, both present even at 0; the cross-rank
    statistics of a data-parallel step count in neither). The
    call's record, {"device", "seconds", "spans": {name: [count,
    seconds]}, "counters"}, is then
    ``profiling.last_record("train_vqvae")``. With the timing log set, the
    call appends one line an epoch (``stage`` "train.epoch", ``epoch``,
    ``seconds``, and the epoch's spans and counters) and one for the call
    (``stage`` "train_vqvae", and its record). Otherwise nothing is
    recorded, and a span costs a flag test.
    """
    if val_split_ratio is not None and not 0 < val_split_ratio < 1:
        raise ValueError(f"val_split_ratio {val_split_ratio} not in (0, 1)")
    comm = _data_parallel_comm()
    world, rank = (1, 0) if comm is None else (comm.world, comm.rank)
    if traj_sharded_loss and (comm is None or relation_mat is None):
        raise ValueError("traj_sharded_loss requires a process group "
                         "(core.mesh.init_multihost) and a relation_mat")
    if comm is not None:
        _check_batch_splits(batch_size, world, "batch_size")
    rec = profiling.Record.of_call()
    with rec.span("train.call"):
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
            if mesh.is_main_process():
                print(f"Resuming from {output_dir} at epoch {start_epoch}")
        if comm is not None:
            mesh.broadcast_state(model, comm)
        traj_ids = SL.trajectory_ids_from_relations(
            relation_mat, len(dataset)) if traj_sharded_loss else None
        train_step = make_train_step(model, optimizer, augment=transform,
                                     generator=generator, comm=comm)
        eval_step = make_eval_step(model, generator=generator, comm=comm)

        train_ids, val_ids = data_utils.split_data_ids(
            len(dataset), val_split_ratio, shuffle_data, rng)
        if comm is not None:
            # every rank's shard of every batch is the same size
            train_ids = train_ids[:len(train_ids)
                                  - len(train_ids) % batch_size]
            val_ids = val_ids[:len(val_ids) - len(val_ids) % batch_size]
            if traj_sharded_loss and not train_ids:
                raise ValueError(
                    f"traj_sharded_loss requires at least one full batch: a "
                    f"dataset of {len(dataset)} leaves no training batch of "
                    f"{batch_size} after the {val_split_ratio} val split")
        n_batches = int(np.ceil(len(train_ids) / batch_size))
        n_val_batches = int(np.ceil(len(val_ids) / batch_size))

        writer = MetricsWriter(output_dir) if mesh.is_main_process() \
            else None
        early = EarlyStopping(patience=patience or 10 ** 9, path=output_dir,
                              verbose=True, record=rec)
        history = []
        edges = _PassEdges(rec)

        def to_dev(array):
            """A host array on the device, counted in ``train.h2d_bytes``."""
            rec.count("train.h2d_bytes", array.nbytes)
            return torch.from_numpy(array).to(dev)

        # Device-resident feed (one process): the patches (and the uint8 mask,
        # transformed once by slice_mask over the whole set, so the two feeds
        # cannot diverge) upload once, and each batch is an int32 index gather
        # on the device; only the uint8 relation blocks travel per step. The
        # gate counts both, so a dataset that barely fits does not run out once
        # the mask uploads too. In a process group each rank uploads its own
        # shard of each batch instead.
        resident_bytes = dataset.nbytes + (
            0 if mask is None else len(mask) * int(np.prod(mask.shape[2:])))
        resident = comm is None and resident_bytes <= _DEVICE_RESIDENT_BUDGET
        if resident:
            with rec.span("train.upload"):
                dataset_src = to_dev(np.ascontiguousarray(dataset))
                mask_src = None if mask is None else to_dev(
                    data_utils.slice_mask(mask, np.arange(len(mask))))

        def load_batch(bids):
            """Relation slice and the batch on the device (a gather when
            resident, a host copy and upload when streamed). Runs in a prefetch
            thread so the next batch's feed overlaps the current step."""
            with rec.span("train.load"):
                if traj_sharded_loss:
                    bids = SL.pack_trajectories(bids, traj_ids, world)
                    b = len(bids) // world
                    rel = SL.blockdiag_relations(
                        relation_mat, bids, world)[rank * b:(rank + 1) * b]
                else:
                    rel = data_utils.slice_relation_mat(relation_mat, bids)
                rel = None if rel is None else to_dev(rel)
                if resident:
                    bidx = to_dev(np.asarray(bids, np.int32))
                    batch = torch.index_select(dataset_src, 0, bidx)
                    bmask = None if mask_src is None else \
                        torch.index_select(mask_src, 0, bidx)
                else:
                    if comm is not None:        # this rank's rows only
                        b = len(bids) // world
                        bids = np.asarray(bids)[rank * b:(rank + 1) * b]
                    batch = to_dev(np.ascontiguousarray(dataset[bids]))
                    bmask = data_utils.slice_mask(mask, bids)
                    bmask = None if bmask is None else to_dev(bmask)
                return batch, rel, bmask

        def run_epoch(ids, n_b, training, epoch):
            # loss sums stay on the device; one host sync per pass
            totals = None
            feed = iter(Prefetcher([ids[i * batch_size: (i + 1) * batch_size]
                                    for i in range(n_b)], load_batch,
                                   depth=2))
            step = train_step if training else eval_step
            steps = "train.steps" if training else "train.val_steps"
            for i in range(n_b):
                with rec.span("train.feed_wait"):
                    _, (batch, rel, bmask) = next(feed)
                if i == 0:
                    edges.first_step(epoch if training else None)
                losses = step(batch, rel, bmask)
                rec.count(steps)
                totals = losses if totals is None else \
                    {k: totals[k] + v for k, v in losses.items()}
            feed.close()        # the Prefetcher's pool shuts down
            means = _mean_losses(totals, n_b)
            edges.synced()
            return means

        bn_kernel = batch_norm_train.launches
        bn_fallback = batch_norm_train.fallbacks
        tm_before = getattr(model, "tm_loss_fn", None)
        if traj_sharded_loss:
            model.tm_loss_fn = SL.make_traj_sharded_tm_loss(comm)
        try:
            for epoch in range(start_epoch, n_epochs):
                train_losses = run_epoch(train_ids, n_batches, True, epoch)
                val_losses = run_epoch(val_ids, n_val_batches, False, epoch)
                if writer is not None:
                    writer.write("Loss", train_losses, epoch)
                    writer.write("Val loss", val_losses, epoch)
                history.append({"epoch": epoch, "train": train_losses,
                                "val": val_losses})
                if save_every_epoch:
                    # legacy per-epoch checkpoints (reference
                    # vq_vae_supp.py:385)
                    _save_on_main(os.path.join(output_dir,
                                               f"model_epoch{epoch}"), model,
                                  record=rec)
                if not val_losses:
                    # no val batch: early-stop on the train loss, which
                    # rarely plateaus, so runs tend to go the full n_epochs
                    if epoch == start_epoch:
                        warnings.warn(
                            "validation split has no batch; early stopping "
                            "will monitor the TRAIN loss (patience may never "
                            "trigger)")
                    val_losses = train_losses
                early(val_losses["total_loss"], model, optimizer, epoch)
                # the losses are the same on every rank; the flags make sure
                if any(mesh.allgather_flags(early.early_stop)):
                    if mesh.is_main_process():
                        print("Early stopping")
                    break
                if shuffle_data and epoch < n_epochs - 1:
                    # reshuffle for the NEXT epoch only, after the
                    # early-stop check
                    rng.shuffle(train_ids)
            if writer is not None:
                writer.close()
        finally:
            edges.close()
            if traj_sharded_loss:
                model.tm_loss_fn = tm_before
        rec.count("train.bn_kernel", batch_norm_train.launches - bn_kernel)
        rec.count("train.bn_fallback",
                  batch_norm_train.fallbacks - bn_fallback)
    rec.keep("train_vqvae", "train.call", device=dev.type)
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

    In a process group every rank builds the same global batches on the
    host (``np.random``, which the datasets draw from by default, is
    seeded on every rank from rank 0's draw first) and uploads its shard;
    the miner sees the gathered batch. A batch's rows (``batch_size *
    n_sample``) must split evenly over the ranks, and partial batches are
    dropped.
    """
    comm = _data_parallel_comm()
    world, rank = (1, 0) if comm is None else (comm.world, comm.rank)
    full_rows = batch_size * train_set.n_sample
    if comm is not None:
        _check_batch_splits(full_rows, world,
                            f"a batch of {batch_size} anchors x "
                            f"{train_set.n_sample} samples =")
    dev = resolve_device(device)
    os.makedirs(output_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    model.to(dev)
    if has_checkpoint(output_dir) and not retrain:
        if mesh.is_main_process():
            print(f"Found previously saved model state {output_dir}. "
                  "Continue training...")
        restore_checkpoint(output_dir, model)
    if comm is not None:
        mesh.broadcast_state(model, comm)
        host_seed = torch.randint(0, 2 ** 31 - 1, (1,), dtype=torch.int64)
        comm.broadcast(host_seed)
        np.random.seed(int(host_seed))
    optimizer = torch.optim.Adam(model.parameters(), lr=lr,
                                 betas=(0.9, 0.999), eps=1e-8)
    train_step, eval_step = make_triplet_steps(model, optimizer, comm=comm)

    writer = MetricsWriter(output_dir) if mesh.is_main_process() else None
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
                if comm is not None:
                    if len(data) != full_rows:
                        continue        # a partial batch: dropped
                    b = full_rows // world
                    data = data[rank * b:(rank + 1) * b]
                    labels = labels[rank * b:(rank + 1) * b]
                losses = step(upload(np.asarray(data, np.float32), dev),
                              upload(np.asarray(labels), dev))
                totals = losses if totals is None else \
                    {k: totals[k] + v for k, v in losses.items()}
                count += 1
            means[training] = _mean_losses(totals, count)
        train_losses, val_losses = means[True], means[False]
        if writer is not None:
            writer.write("Loss", train_losses, epoch)
            writer.write("Val loss", val_losses, epoch)
        history.append({"epoch": epoch, "train": train_losses,
                        "val": val_losses})
        if not train_losses:
            raise ValueError(
                f"no training batches ran: the dataset ({len(train_set)} "
                f"anchors) must cover at least one "
                f"{'full ' if comm is not None else ''}batch of "
                f"{batch_size} anchors" +
                (f" (multi-process runs drop partial batches; the "
                 f"{world} ranks need a full batch)"
                 if comm is not None else ""))
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
        if any(mesh.allgather_flags(early.early_stop)):
            if mesh.is_main_process():
                print("Early stopping")
            break
    if writer is not None:
        writer.close()
    return model, history
