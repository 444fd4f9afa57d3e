"""Model training entry point (reference run_training.py:771-966;
``dynamorph_tpu/cli/run_training.py``): the VQ-VAE family (VQ_VAE_z16,
VQ_VAE_z32, VAE, IWAE, AAE) or a ResNet/SimCLR encoder (ResNet18, 50,
101, 152) with the triplet miner.

Usage: python -m dynamorph_tpu_torch.cli.run_training -c <config.yml>
       [--device cuda|cpu]
       [--multihost [--coordinator host:port --num-processes N
                     --process-id i]]

Dataflow: per raw_dir, load ``im_static_patches`` (pickle or compact npz),
its labels and relations; z-score; concatenate the relations across dirs
with cumulative offsets. The VQ-VAE family is reordered
trajectory-contiguously and trained with the time-matching loss; a ResNet
samples positive sets from the labels (``train/triplet_data.py``) and
trains with the triplet miner.

A run uses every card the process sees, as the JAX package trains on all
of a process's devices (dynamorph_tpu/cli/run_training.py:99-108,
:154-162): with more than one device (``run(devices=)``; by default
``core.mesh.local_devices()`` when the run is on the card) and no process
group yet, ``run`` starts one local rank a device
(``core.mesh.run_local_ranks``: NCCL between cards of their own, gloo
between ranks that share one or on the CPU), and each rank runs the
data-parallel path below. One device, ``--device cpu`` without
``devices=``, and ``--multihost`` run in this process.

``--multihost`` trains data-parallel, one process a card, every rank
launched with the same config (the trio of flags, or torchrun's variables;
``core.mesh.init_multihost``): ``training.batch_size`` is the global batch
and must be a multiple of the world size. The VQ-VAE family then packs
whole trajectories onto the ranks and runs the trajectory-sharded ring
loss, as the JAX package chooses ``traj_sharded`` on a multi-device mesh
(dynamorph_tpu/cli/run_training.py:93-126). Rank 0 writes ``model.pt``.
Under ``--multihost`` a process uses its rank's card only.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

from ..config import load_config
from ..core import mesh
from ..core.device import resolve_device
from ..io.compact import load_array_any
from ..io.pickles import load_pickle
from ..models.registry import build_model
from ..models.resnet_simclr import EncodeProject
from ..pipeline.patch_vae import _load_model_weights
from ..train import data as data_utils
from ..train.checkpoint import MODEL_FILE
from ..train.trainer import train_triplet, train_vqvae
from ..train.triplet_data import TripletDataset, augment_img
from .common import config_parser, init_multihost_from_args


def _start_weights(model, path: Optional[str]) -> None:
    """``start_model_path``: a reference-format model.pt, or a directory
    holding one (a port training run's output); an orbax directory
    raises."""
    if not path:
        return
    if os.path.isdir(path) and os.path.exists(os.path.join(path, MODEL_FILE)):
        path = os.path.join(path, MODEL_FILE)
    _load_model_weights(model, path)


def _triplet_model(tr) -> EncodeProject:
    return EncodeProject(arch=tr.network, num_inputs=tr.num_inputs,
                         margin=tr.margin)


def _vae_model(tr):
    return build_model(
        tr.network,
        num_inputs=tr.num_inputs,
        num_hiddens=tr.num_hiddens,
        num_residual_hiddens=tr.num_residual_hiddens,
        num_residual_layers=tr.num_residual_layers,
        num_embeddings=tr.num_embeddings,
        commitment_cost=tr.commitment_cost,
        weight_matching=tr.weight_matching,
        w_a=tr.w_a, w_t=tr.w_t, w_n=tr.w_n, margin=tr.margin,
        vq_train_precision=tr.vq_train_precision)


def _local_rank_main(config, seed: int):
    """One local rank of ``run``: the host and torch RNG streams seeded
    from the caller's draw, then the data-parallel run on this rank's
    device. Returns the history."""
    np.random.seed(seed)
    torch.manual_seed(seed)
    return run(config, device=mesh.rank_device())[1]


def _run_local_ranks(config, dev, devices):
    """``run`` over one local rank a device: rank 0's history, and the
    model rank 0 wrote, loaded onto ``dev``."""
    tr = config.training
    seed = int(np.random.randint(0, 2 ** 31 - 1))
    history = mesh.run_local_ranks(_local_rank_main, (config, seed),
                                   devices)[0]
    model = _triplet_model(tr) if "ResNet" in tr.network else _vae_model(tr)
    _load_model_weights(model, os.path.join(
        tr.weights_dirs[-1], tr.model_name, MODEL_FILE))
    return model.to(dev), history


def _run_triplet(tr, dataset, labels, model_dir, dev):
    """The ResNet branch (dynamorph_tpu/cli/run_training.py:129-162): a
    seeded train/val split, positive sets of ``n_pos_samples`` patches
    with the augmentation and the draws on the global ``np.random``, and
    ``batch_size / n_pos_samples`` anchors a step."""
    train_set, train_labels, val_set, val_labels = \
        data_utils.train_val_split(dataset, labels,
                                   val_split_ratio=tr.val_split_ratio, seed=0)
    tri_train = TripletDataset(
        train_labels, lambda i: augment_img(train_set[i]), tr.n_pos_samples)
    tri_val = TripletDataset(
        val_labels, lambda i: augment_img(val_set[i]), tr.n_pos_samples)
    batch_size_adj = int(np.floor(tr.batch_size / tr.n_pos_samples))
    model = _triplet_model(tr)
    _start_weights(model, tr.start_model_path)
    return train_triplet(model, tri_train, tri_val, model_dir,
                         n_epochs=tr.n_epochs, lr=tr.learn_rate,
                         batch_size=batch_size_adj, patience=tr.patience,
                         earlystop_metric=tr.earlystop_metric,
                         retrain=tr.retrain, log_step_offset=tr.start_epoch,
                         device=dev)


def run(config, device: str = "cuda", devices=None):
    """Train the configured network. Returns (model, history). Over more
    than one device (``devices``, by default this process's cards when
    ``device`` is the card) the run trains on one local rank a device and
    returns rank 0's history and model (module docstring)."""
    dev = resolve_device(device)
    if not mesh.is_distributed():
        devices = mesh.fan_out_devices(devices, dev)
        if len(devices) > 1:
            return _run_local_ranks(config, dev, devices)
    tr = config.training
    dir_sets = list(zip(tr.supp_dirs, tr.weights_dirs, tr.raw_dirs))

    datasets, masks, relations, labels_list = [], [], [], []
    id_offsets = [0]
    for _, train_dir, raw_dir in dir_sets:
        os.makedirs(train_dir, exist_ok=True)
        # static patches may be pickle or compact npz (io/compact.py)
        dataset = load_array_any(
            os.path.join(raw_dir, "im_static_patches.pkl"))
        label = load_pickle(
            os.path.join(raw_dir, "im_static_patches_labels.pkl"))
        relations.append(load_pickle(
            os.path.join(raw_dir, "im_static_patches_relations.pkl")))
        dataset = data_utils.zscore(
            np.squeeze(dataset), channel_mean=tr.channel_mean,
            channel_std=tr.channel_std).astype(np.float32)
        datasets.append(dataset)
        labels_list.append(label)
        id_offsets.append(len(dataset))
        if tr.use_mask:
            masks.append(load_array_any(
                os.path.join(raw_dir, "im_static_patches_mask.pkl")))
    # cumulative offsets [0, n0, n0+n1, ...]: the reference keeps raw
    # per-dir lengths (run_training.py:866-871), mis-indexing the
    # third-and-later dirs' relations/labels into the concatenated dataset
    id_offsets = list(np.cumsum(id_offsets[:-1]))
    dataset = np.concatenate(datasets, axis=0)
    mask = np.concatenate(masks, axis=0) if tr.use_mask else None
    relations, labels = data_utils.concat_relations(
        relations, labels_list, offsets=id_offsets)
    model_dir = os.path.join(dir_sets[-1][1], tr.model_name)
    if "ResNet" in tr.network:
        return _run_triplet(tr, dataset, labels, model_dir, dev)

    dataset, relation_mat, order = data_utils.reorder_with_trajectories(
        dataset, relations, seed=123)
    labels = labels[np.asarray(order)]
    if mask is not None:
        mask = mask[np.asarray(order)]
    traj_sharded = mesh.is_distributed() and relation_mat is not None
    model = _vae_model(tr)
    _start_weights(model, tr.start_model_path)
    # retrain=False lets an interrupted run continue from the output dir's
    # checkpoint (weights, optimizer moments, epoch); retrain=True starts a
    # fresh optimizer and epoch count
    return train_vqvae(model, dataset, model_dir,
                       relation_mat=relation_mat, mask=mask,
                       n_epochs=tr.n_epochs, lr=tr.learn_rate,
                       batch_size=tr.batch_size, transform=True,
                       shuffle_data=tr.shuffle_data,
                       val_split_ratio=tr.val_split_ratio,
                       patience=tr.patience, resume=not tr.retrain,
                       traj_sharded_loss=traj_sharded, device=dev)


def main(argv: Optional[Sequence[str]] = None):
    args = config_parser().parse_args(argv)
    init_multihost_from_args(args)
    return run(load_config(args.config), device=args.device)


if __name__ == "__main__":
    main()
