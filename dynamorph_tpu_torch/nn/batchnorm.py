"""Batch norm over the global batch of a data-parallel step.

Under the JAX package's mesh a train step is one program over the global
batch, so its batch norm (dynamorph_tpu/nn/functional.py:146-180) takes the
global batch's statistics. Per-rank statistics would give another step, so
inside ``cross_rank_batch_norm`` every batch norm of the model that runs in
training mode under a ``core.mesh.collective_scope`` normalises with the
mean and biased variance of all ranks' rows: two passes, as the port's
single-rank batch norm takes them (the sum, then the squared deviations from
the global mean, each all-reduced), with the gradient through both
all-reduces. The running buffers are updated from the global statistics
(unbiased variance, torch's momentum), so they come out equal on every rank.

``torch.nn.SyncBatchNorm`` does not serve: it refuses CPU tensors
(torch 2.13's forward raises unless the input is on a GPU), where the tests
run, and its statistics are one-pass.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Iterator

import torch
from torch import nn

from ..core.mesh import all_reduce_sum, current_comm


def _global_batch_norm(bn: nn.modules.batchnorm._BatchNorm, x, comm):
    dims = [0] + list(range(2, x.dim()))
    shape = [1, -1] + [1] * (x.dim() - 2)
    count = (x.numel() // x.shape[1]) * comm.world     # equal shards
    mean = all_reduce_sum(x.sum(dims), comm) / count
    d = x - mean.reshape(shape)
    var = all_reduce_sum((d * d).sum(dims), comm) / count
    y = d * torch.rsqrt(var + bn.eps).reshape(shape)
    if bn.affine:
        y = y * bn.weight.reshape(shape) + bn.bias.reshape(shape)
    if bn.track_running_stats and bn.running_mean is not None:
        with torch.no_grad():
            bn.num_batches_tracked.add_(1)
            m = bn.momentum if bn.momentum is not None else \
                1.0 / float(bn.num_batches_tracked)
            bn.running_mean.mul_(1 - m).add_(mean.detach(), alpha=m)
            bn.running_var.mul_(1 - m).add_(
                var.detach() * (count / max(count - 1, 1)), alpha=m)
    return y


def _forward(bn, own_forward, x):
    comm = current_comm()
    if comm is None or not bn.training:
        return own_forward(x)
    return _global_batch_norm(bn, x, comm)


@contextlib.contextmanager
def cross_rank_batch_norm(model: nn.Module) -> Iterator[None]:
    """Every batch norm of ``model`` takes the global batch's statistics
    inside the block when it runs in training mode under a collective
    scope, and its own otherwise; the modules are as they were after it."""
    patched = [m for m in model.modules()
               if isinstance(m, nn.modules.batchnorm._BatchNorm)]
    for m in patched:
        m.forward = functools.partial(_forward, m, m.forward)
    try:
        yield
    finally:
        for m in patched:
            del m.forward
