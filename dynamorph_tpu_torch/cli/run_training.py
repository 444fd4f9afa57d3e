"""Model training entry point, VQ-VAE family (reference run_training.py:
771-966; the VAE branch of ``dynamorph_tpu/cli/run_training.py:27-128``).

Usage: python -m dynamorph_tpu_torch.cli.run_training -c <config.yml>
       [--device cuda|cpu]

Dataflow: per raw_dir, load ``im_static_patches`` (pickle or compact npz),
its labels and relations; z-score; concatenate the relations across dirs
with cumulative offsets; reorder trajectory-contiguously; train with the
time-matching loss on one device. The ResNet/SimCLR triplet branch is not
ported yet and refuses with a message.
"""
from __future__ import annotations

import argparse
import inspect
import os
from typing import Optional, Sequence

import numpy as np

from ..config import load_config
from ..core.device import resolve_device
from ..io.compact import load_array_any
from ..io.pickles import load_pickle
from ..models.registry import get_model_cls
from ..pipeline.patch_vae import _load_model_weights
from ..train import data as data_utils
from ..train.checkpoint import MODEL_FILE
from ..train.trainer import train_vqvae

_NOT_PORTED = ("training network {network!r} (the ResNet/SimCLR triplet "
               "branch) is not ported yet; it comes with ROADMAP slice E "
               "(other model families)")


def _init_kwargs(cls) -> set:
    """The keyword arguments that ``cls(...)`` names in its ``__init__``
    chain (the JAX branch filters by the dataclass's fields)."""
    names = set()
    for klass in cls.__mro__:
        init = klass.__dict__.get("__init__")
        if init is None:
            continue
        names |= {p.name for p in inspect.signature(init).parameters.values()
                  if p.kind in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY)}
    names.discard("self")
    return names


def run(config, device: str = "cuda"):
    """Train the configured network. Returns (model, history)."""
    dev = resolve_device(device)
    tr = config.training
    if "ResNet" in tr.network:
        raise NotImplementedError(_NOT_PORTED.format(network=tr.network))
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

    dataset, relation_mat, order = data_utils.reorder_with_trajectories(
        dataset, relations, seed=123)
    labels = labels[np.asarray(order)]
    if mask is not None:
        mask = mask[np.asarray(order)]
    model_cls = get_model_cls(tr.network)
    model_kwargs = dict(
        num_inputs=tr.num_inputs,
        num_hiddens=tr.num_hiddens,
        num_residual_hiddens=tr.num_residual_hiddens,
        num_residual_layers=tr.num_residual_layers,
        num_embeddings=tr.num_embeddings,
        commitment_cost=tr.commitment_cost,
        weight_matching=tr.weight_matching,
        w_a=tr.w_a, w_t=tr.w_t, w_n=tr.w_n, margin=tr.margin,
        vq_train_precision=tr.vq_train_precision)
    accepted = _init_kwargs(model_cls)
    model = model_cls(
        **{k: v for k, v in model_kwargs.items() if k in accepted})
    if tr.start_model_path:
        # a reference-format model.pt, or a directory holding one (a port
        # training run's output); an orbax directory raises
        path = tr.start_model_path
        if os.path.isdir(path) and \
                os.path.exists(os.path.join(path, MODEL_FILE)):
            path = os.path.join(path, MODEL_FILE)
        _load_model_weights(model, path)
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
                       device=dev)


def main(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-c", "--config", type=str, required=True,
                        help="path to yaml configuration file")
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"],
                        help="device to run on (default: cuda; without a "
                             "card the run fails unless --device cpu)")
    args = parser.parse_args(argv)
    return run(load_config(args.config), device=args.device)


if __name__ == "__main__":
    main()
