"""Adversarial (AAE) training loop — the port of
``dynamorph_tpu/train/adversarial.py`` for one device.

Behavioral spec: reference run_training.py:630-769 — per batch: (1) optimise
encoder+decoder on the reconstruction/matching loss, (2) optimise the
discriminator on D-loss, (3) optimise the encoder on G-loss; separate Adam
optimisers per parameter group (lr_recon / lr_dis / lr_gen); per-epoch
``model_epoch%d`` checkpoints.

Each update is its own ``torch.optim.Adam`` over its own parameters, so it
moves only its group. The JAX package builds its three optimisers with
``optax.masked`` over the whole tree, which passes the leaves outside a
mask through as raw gradients; ``apply_updates`` then adds the generator
loss's gradient to the discriminator's weights at every step (the other two
updates' out-of-group gradients are zero). The port does not copy that:
``tests/test_torch_adversarial.py`` shows the difference.

As in the JAX step, the discriminator update sees the batch-norm state the
reconstruction update left, and the step ends with the state the
discriminator update left: the generator update's forward runs in train
mode, and its running statistics are put back after it.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

from ..core.device import fp32_strict, resolve_device
from . import data as data_utils
from .checkpoint import save_checkpoint
from .metrics import MetricsWriter
from .steps import _as_float, augment_batch

# the three updates in the order of the step, and the top-level modules
# each one optimises
STAGES = ("recon", "dis", "gen")
GROUPS = {"recon": ("enc", "dec"), "dis": ("enc_d",), "gen": ("enc",)}


def group_parameters(model, stage: str):
    """The parameters that ``stage``'s update moves."""
    return [p for n, p in model.named_parameters()
            if n.split(".")[0] in GROUPS[stage]]


def make_optimizers(model, lr_recon: float = 1e-3, lr_dis: float = 1e-3,
                    lr_gen: float = 1e-3) -> Dict[str, torch.optim.Adam]:
    """One Adam (0.9, 0.999, eps 1e-8: ``optax.adam``'s update) per update,
    over that update's parameter group only."""
    lrs = {"recon": lr_recon, "dis": lr_dis, "gen": lr_gen}
    return {s: torch.optim.Adam(group_parameters(model, s), lr=lrs[s],
                                betas=(0.9, 0.999), eps=1e-8)
            for s in STAGES}


def stage_loss(model, stage: str, batch: torch.Tensor, rel=None, mask=None,
               generator: Optional[torch.Generator] = None,
               noise: Optional[Dict] = None):
    """The train-mode forward of one update: (the loss it minimises, its
    losses dict). ``noise`` holds ``adversarial_loss``'s ``z_prior`` and
    ``keep`` for the two adversarial updates; what it lacks is drawn from
    ``generator``."""
    if stage == "recon":
        _, losses = model.apply(batch, train=True, time_matching_mat=rel,
                                batch_mask=mask)
        return losses["total_loss"], losses
    adv = model.adversarial_loss(batch, train=True, generator=generator,
                                 **(noise or {}))
    key = "descriminator_loss" if stage == "dis" else "generator_loss"
    return adv[key], adv


def _running_buffers(model) -> Dict[str, torch.Tensor]:
    return {n: b.detach().clone() for n, b in model.named_buffers()
            if n.endswith(("running_mean", "running_var",
                           "num_batches_tracked"))}


def make_adversarial_step(model, optimizers: Dict[str, torch.optim.Adam],
                          augment: bool = True,
                          generator: Optional[torch.Generator] = None
                          ) -> Callable[..., Dict[str, torch.Tensor]]:
    """``step(batch, rel, mask) -> losses`` (detached device scalars): one
    step of three updates (``STAGES``), in place. The losses are the
    reconstruction forward's and the discriminator forward's, as the JAX
    step reports them.

    ``generator`` draws the augmentation, then each adversarial update's
    prior sample and dropout masks. A caller may give them instead:
    ``flips`` and ``rots`` (``augment_batch``), and ``noise`` =
    ``{"dis": {...}, "gen": {...}}`` (``stage_loss``)."""

    def step(batch, rel=None, mask=None, flips=None, rots=None,
             noise: Optional[Dict[str, Dict]] = None):
        rel = _as_float(rel, batch.device)
        if mask is not None:        # uint8 through the augmentation
            mask = torch.as_tensor(mask).to(batch.device)
        if augment:
            batch, mask = augment_batch(batch, mask, generator=generator,
                                        flips=flips, rots=rots)
        mask = _as_float(mask, batch.device)
        out = {}
        with fp32_strict():
            for stage in STAGES:
                saved = _running_buffers(model) if stage == "gen" else None
                model.zero_grad(set_to_none=True)
                loss, losses = stage_loss(model, stage, batch, rel, mask,
                                          generator, (noise or {}).get(stage))
                loss.backward()
                optimizers[stage].step()
                if saved is not None:
                    bufs = dict(model.named_buffers())
                    with torch.no_grad():
                        for n, b in saved.items():
                            bufs[n].copy_(b)
                else:
                    out.update(losses)
        return {k: v.detach() for k, v in out.items()}

    return step


def train_adversarial(model, dataset: np.ndarray, output_dir: str,
                      relation_mat=None, mask: Optional[np.ndarray] = None,
                      n_epochs: int = 10, lr_recon: float = 1e-3,
                      lr_dis: float = 1e-3, lr_gen: float = 1e-3,
                      batch_size: int = 16, shuffle_data: bool = False,
                      transform: bool = True, seed: Optional[int] = None,
                      device: Union[str, torch.device] = "cuda",
                      generator: Optional[torch.Generator] = None):
    """Train an ``AAEModel`` in place. Returns (model, history).

    ``model`` starts from the weights it holds. Each epoch appends
    ``{"epoch", <mean losses>}`` to the history (the losses summed on the
    device, fetched once an epoch), writes a ``Loss`` row to
    ``metrics.jsonl`` and ``<output_dir>/model_epoch<e>/model.pt``
    (reference names; ``run_vae -m process`` loads it strict). The
    sample order is shuffled with ``np.random.RandomState(seed)``, as in the
    JAX package. ``generator`` (default: one on the device seeded with
    ``seed``) draws the augmentation and the adversarial noise. ``device``
    is the card unless the caller passes "cpu"; without a card the call
    raises."""
    dev = resolve_device(device)
    os.makedirs(output_dir, exist_ok=True)
    seed = 0 if seed is None else seed
    rng = np.random.RandomState(seed)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(seed)
    model.to(dev)
    step = make_adversarial_step(
        model, make_optimizers(model, lr_recon, lr_dis, lr_gen),
        augment=transform, generator=generator)

    writer = MetricsWriter(output_dir)
    n = len(dataset)
    sample_ids = np.arange(n)
    if shuffle_data:
        rng.shuffle(sample_ids)
    n_batches = int(np.ceil(n / batch_size))
    history = []
    for epoch in range(n_epochs):
        totals = None
        for i in range(n_batches):
            bids = sample_ids[i * batch_size: (i + 1) * batch_size]
            batch = torch.from_numpy(np.ascontiguousarray(
                dataset[bids], dtype=np.float32)).to(dev)
            losses = step(batch,
                          data_utils.slice_relation_mat(relation_mat, bids),
                          data_utils.slice_mask(mask, bids))
            totals = losses if totals is None else \
                {k: totals[k] + v for k, v in losses.items()}
        if shuffle_data:
            rng.shuffle(sample_ids)
        keys = sorted(totals)
        sums = torch.stack([totals[k] for k in keys]).cpu().tolist()
        mean_loss = {k: s / n_batches for k, s in zip(keys, sums)}
        writer.write("Loss", mean_loss, epoch)
        history.append({"epoch": epoch, **mean_loss})
        # per-epoch checkpoint (reference run_training.py:767)
        save_checkpoint(os.path.join(output_dir, f"model_epoch{epoch}"),
                        model)
    writer.close()
    return model, history
