"""Train and eval steps for the VQ-VAE family and the triplet path (the
port of ``dynamorph_tpu/train/steps.py``), on one device or data-parallel
across the ranks of a process group.

A step takes a batch already on the device, the uint8 relation block and the
uint8 mask (4x fewer bytes to send than float32), casts both to float32 on
the device (the mask after augmentation) and runs ``model.apply``. The
train step then runs the backward and the Adam update, all inside
``core.device.fp32_strict``: cuDNN reads its TF32 switch when each backward
convolution is dispatched, so the block has to cover ``backward()`` too.

On-device augmentation (random flip + rot90 per image, reference
run_training.py:396-403) runs inside the train step.

Models whose ``apply`` draws noise (VAE, IWAE: an ``apply`` that takes a
``generator``) get the step's generator, after the augmentation has drawn
from it; the JAX package decides the same by the signature (``needs_key``,
dynamorph_tpu/train/trainer.py:157-166).

Data-parallel (``comm``, a ``core.mesh`` communicator): each rank's step
takes its equal shard of the global batch and runs under
``core.mesh.collective_scope(comm)``, in which the models' losses, batch
norm (``nn.batchnorm.cross_rank_batch_norm``), time-matching loss and triplet miner are the global batch's, as under the
JAX package's mesh; the augmentation and the models' noise are drawn for
the global batch from the identically seeded generator of every rank
(``core.mesh.global_rows`` / ``rank_rows``), and each rank keeps its rows. After the backward the gradients are averaged
over the ranks in one all-reduce, so every rank's Adam takes the same step.
"""
from __future__ import annotations

import contextlib
import inspect
from typing import Callable, Dict, Optional

import torch

from ..core.device import fp32_strict
from ..core.mesh import (average_gradients, collective_scope, global_rows,
                         rank_rows)
from ..nn.batchnorm import cross_rank_batch_norm


def _dihedral(x: torch.Tensor, flips: torch.Tensor,
              rots: torch.Tensor) -> torch.Tensor:
    """Per image of an (N, C, H, W) batch: flip in {0: none, 1: H, 2: W},
    then rot90 ``rots`` times in the (H, W) plane (``_dihedral``,
    dynamorph_tpu/train/steps.py:23-38; ``torch.rot90`` and ``jnp.rot90``
    share numpy's convention). All variants are computed and one is selected
    per image, so no draw goes back to the host. Needs H == W, as the JAX
    version does."""
    if x.shape[-1] != x.shape[-2]:
        raise ValueError(f"augmentation needs square patches, got "
                         f"{tuple(x.shape[-2:])}")

    def pick(choice, variants):
        c = choice.reshape(-1, *([1] * (x.dim() - 1)))
        out = variants[0]
        for i, v in enumerate(variants[1:], 1):
            out = torch.where(c == i, v, out)
        return out

    x = pick(flips, [x, torch.flip(x, (2,)), torch.flip(x, (3,))])
    return pick(rots, [x] + [torch.rot90(x, k, (2, 3)) for k in (1, 2, 3)])


def augment_batch(batch: torch.Tensor, mask: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None,
                  flips: Optional[torch.Tensor] = None,
                  rots: Optional[torch.Tensor] = None):
    """Random PER-IMAGE flip + k*90-degree rotation of NCHW patches
    (reference run_one_batch, run_training.py:396-403).

    The draws are ``flips`` in {0, 1, 2} and ``rots`` in {0, 1, 2, 3}, one
    per image: given by the caller, or drawn from ``generator`` (a
    ``torch.Generator`` on the batch's device; torch's default one if None).
    Under a data-parallel step the draws are the global batch's, of which
    this rank keeps its rows, so every world size augments a row alike.

    As in the JAX package, and unlike the reference, the recon mask moves
    WITH its image (dynamorph_tpu/train/steps.py:47-51): the reference
    augments only the batch, mis-aligning the masked recon loss.
    """
    n = global_rows(batch.shape[0])
    if flips is None:
        flips = rank_rows(torch.randint(0, 3, (n,), generator=generator,
                                        device=batch.device))
    if rots is None:
        rots = rank_rows(torch.randint(0, 4, (n,), generator=generator,
                                       device=batch.device))
    flips, rots = flips.to(batch.device), rots.to(batch.device)
    batch = _dihedral(batch, flips, rots)
    if mask is not None:
        mask = _dihedral(mask, flips, rots)
    return batch, mask


def _as_float(t, device) -> Optional[torch.Tensor]:
    """A uint8 block or mask on ``device``, cast there to float32."""
    if t is None:
        return None
    return torch.as_tensor(t).to(device).to(torch.float32)


def _noise_kwargs(model, generator) -> Dict:
    """``{"generator": generator}`` for a model whose ``apply`` draws
    noise, else nothing."""
    if "generator" in inspect.signature(model.apply).parameters:
        return {"generator": generator}
    return {}


@contextlib.contextmanager
def _data_parallel(model, comm):
    """The global batch's semantics for the block's forward and backward
    (nothing changes without ``comm``)."""
    if comm is None:
        yield
        return
    with collective_scope(comm), cross_rank_batch_norm(model):
        yield


def _backward_and_update(model, optimizer, loss, comm) -> None:
    loss.backward()
    if comm is not None:
        average_gradients(model.parameters(), comm)
    optimizer.step()


def make_train_step(model, optimizer: torch.optim.Optimizer,
                    augment: bool = True,
                    generator: Optional[torch.Generator] = None, comm=None
                    ) -> Callable[..., Dict[str, torch.Tensor]]:
    """``step(batch, rel, mask) -> losses`` (detached device scalars) for a
    model with ``apply(x, train, time_matching_mat, batch_mask)``. It updates
    the model's parameters (through ``optimizer``) and its batch-norm
    buffers in place. ``generator`` draws the augmentation and the model's
    noise. With ``comm``, ``batch`` and ``mask`` are this rank's shard, and
    ``rel`` its diagonal block under a trajectory-sharded ``tm_loss_fn`` or
    the global (B, B) block otherwise."""
    noise = _noise_kwargs(model, generator)

    def step(batch, rel=None, mask=None):
        rel = _as_float(rel, batch.device)
        if mask is not None:        # uint8 through the augmentation
            mask = torch.as_tensor(mask).to(batch.device)
        with fp32_strict(), _data_parallel(model, comm):
            if augment:
                batch, mask = augment_batch(batch, mask, generator=generator)
            mask = _as_float(mask, batch.device)
            optimizer.zero_grad(set_to_none=True)
            _, losses = model.apply(batch, train=True, time_matching_mat=rel,
                                    batch_mask=mask, **noise)
            _backward_and_update(model, optimizer, losses["total_loss"],
                                 comm)
        return {k: v.detach() for k, v in losses.items()}

    return step


def make_eval_step(model, generator: Optional[torch.Generator] = None,
                   comm=None) -> Callable[..., Dict[str, torch.Tensor]]:
    """``step(batch, rel, mask) -> losses`` with the running batch-norm
    statistics and no autograd (``generator`` draws the model's noise;
    ``comm`` as for ``make_train_step``)."""
    noise = _noise_kwargs(model, generator)

    def step(batch, rel=None, mask=None):
        with _data_parallel(model, comm):
            _, losses = model.apply(
                batch, train=False,
                time_matching_mat=_as_float(rel, batch.device),
                batch_mask=_as_float(mask, batch.device), **noise)
        return losses

    return step


def make_triplet_steps(model, optimizer: torch.optim.Optimizer, comm=None):
    """``(train_step, eval_step)`` for the triplet (ResNet/SimCLR) path,
    each ``step(batch, labels) -> losses``: the reference's
    ``train_with_loader`` inner loop (run_training.py:554-627;
    dynamorph_tpu/train/steps.py:107-148). The train step runs the
    forward, the miner, the backward and Adam inside ``fp32_strict``, and
    updates the batch-norm buffers in place. With ``comm``, ``batch`` and
    ``labels`` are this rank's shard and the miner sees the gathered
    global batch."""

    def train_step(batch, labels):
        with fp32_strict(), _data_parallel(model, comm):
            optimizer.zero_grad(set_to_none=True)
            _, losses = model.apply(batch, labels=labels, train=True)
            _backward_and_update(model, optimizer, losses["total_loss"],
                                 comm)
        return {k: v.detach() for k, v in losses.items()}

    def eval_step(batch, labels):
        with _data_parallel(model, comm):
            _, losses = model.apply(batch, labels=labels, train=False)
        return losses

    return train_step, eval_step
