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

``BatchNorm2d`` is ``torch.nn.BatchNorm2d`` with the ReLU that follows it
folded in (``relu=True``) and its training-mode pass through
``ops.batch_norm.batch_norm_train``: the hand-written kernels on the card,
``F.batch_norm`` (+ ``F.relu``) elsewhere. Under the cross-rank batch norm
its ReLU follows the global statistics, and neither of the op's counters
moves.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Iterator

import torch
from torch import nn
from torch.nn import functional as F

from ..core.mesh import all_reduce_sum, current_comm
from ..ops import batch_norm as bn_ops


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` (same parameters, buffers and ``state_dict``)
    that applies ``F.relu`` to its output where ``relu``, so a ReLU that
    follows it directly is folded in (its slot becomes ``nn.Identity``).
    Training mode runs ``ops.batch_norm.batch_norm_train``, counted there;
    eval mode runs ``nn.BatchNorm2d``'s own forward. It is affine and
    keeps running statistics: the kernels take both."""

    def __init__(self, num_features: int, relu: bool = False, **kw):
        super().__init__(num_features, **kw)
        if not (self.affine and self.track_running_stats):
            raise ValueError("BatchNorm2d takes affine=True and "
                             "track_running_stats=True")
        self.relu = relu

    def extra_repr(self) -> str:
        return super().extra_repr() + (", relu=True" if self.relu else "")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            y = super().forward(x)
            return F.relu(y) if self.relu else y
        # nn.BatchNorm2d.forward's bookkeeping, then its F.batch_norm call
        self._check_input_dim(x)
        self.num_batches_tracked.add_(1)
        factor = self.momentum if self.momentum is not None else \
            1.0 / float(self.num_batches_tracked)
        return bn_ops.batch_norm_train(
            x, self.weight, self.bias, self.running_mean, self.running_var,
            factor, self.eps, relu=self.relu)


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
    y = _global_batch_norm(bn, x, comm)
    return F.relu(y) if isinstance(bn, BatchNorm2d) and bn.relu else y


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
