"""Train and eval steps for the VQ-VAE family (the port of
``dynamorph_tpu/train/steps.py``), on one device.

A step takes a batch already on the device, the uint8 relation block and the
uint8 mask (4x fewer bytes to send than float32), casts both to float32 on
the device (the mask after augmentation) and runs ``model.apply``. The
train step then runs the backward and the Adam update, all inside
``core.device.fp32_strict``: cuDNN reads its TF32 switch when each backward
convolution is dispatched, so the block has to cover ``backward()`` too.

On-device augmentation (random flip + rot90 per image, reference
run_training.py:396-403) runs inside the train step.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..core.device import fp32_strict


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

    As in the JAX package, and unlike the reference, the recon mask moves
    WITH its image (dynamorph_tpu/train/steps.py:47-51): the reference
    augments only the batch, mis-aligning the masked recon loss.
    """
    n = batch.shape[0]
    if flips is None:
        flips = torch.randint(0, 3, (n,), generator=generator,
                              device=batch.device)
    if rots is None:
        rots = torch.randint(0, 4, (n,), generator=generator,
                             device=batch.device)
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


def make_train_step(model, optimizer: torch.optim.Optimizer,
                    augment: bool = True,
                    generator: Optional[torch.Generator] = None
                    ) -> Callable[..., Dict[str, torch.Tensor]]:
    """``step(batch, rel, mask) -> losses`` (detached device scalars) for a
    model with ``apply(x, train, time_matching_mat, batch_mask)``. It updates
    the model's parameters (through ``optimizer``) and its batch-norm
    buffers in place. ``generator`` draws the augmentation."""

    def step(batch, rel=None, mask=None):
        rel = _as_float(rel, batch.device)
        if mask is not None:        # uint8 through the augmentation
            mask = torch.as_tensor(mask).to(batch.device)
        if augment:
            batch, mask = augment_batch(batch, mask, generator=generator)
        mask = _as_float(mask, batch.device)
        with fp32_strict():
            optimizer.zero_grad(set_to_none=True)
            _, losses = model.apply(batch, train=True, time_matching_mat=rel,
                                    batch_mask=mask)
            losses["total_loss"].backward()
            optimizer.step()
        return {k: v.detach() for k, v in losses.items()}

    return step


def make_eval_step(model) -> Callable[..., Dict[str, torch.Tensor]]:
    """``step(batch, rel, mask) -> losses`` with the running batch-norm
    statistics and no autograd."""

    def step(batch, rel=None, mask=None):
        _, losses = model.apply(
            batch, train=False,
            time_matching_mat=_as_float(rel, batch.device),
            batch_mask=_as_float(mask, batch.device))
        return losses

    return step
