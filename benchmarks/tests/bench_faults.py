"""Faults planted in the measured program's timed path, for
``test_bench_faults.py``. Each ``*_session`` patches the program in the
process that runs it (a local rank imports it by name), then runs the
benchmark's session."""
from __future__ import annotations

import contextlib
import sys
import types

import bench_tiny  # noqa: F401
from dynamorph_tpu_torch.core import mesh
from dynamorph_tpu_torch.models import vqvae
from dynamorph_tpu_torch.train import steps
from yardstick import train


def plant(fault: str) -> None:
    if fault == "state_unchanged":
        # the step computes its loss and gradients and leaves the
        # parameters as they were
        steps._backward_and_update = \
            lambda model, optimizer, loss, comm: loss.backward()
    elif fault == "half_batch":
        apply = vqvae.VQVAEBase.apply

        def half(self, x, train=False, time_matching_mat=None,
                 batch_mask=None):
            if train:
                k = x.shape[0] // 2
                x = x[:k]
                if time_matching_mat is not None:
                    time_matching_mat = time_matching_mat[:k, :k]
                if batch_mask is not None:
                    batch_mask = batch_mask[:k]
            return apply(self, x, train, time_matching_mat, batch_mask)

        vqvae.VQVAEBase.apply = half
    elif fault == "no_exchange":
        # each rank steps on its own shard: no collective in the step and
        # no gradient all-reduce
        steps._data_parallel = \
            lambda model, comm: contextlib.nullcontext()
        steps._backward_and_update = \
            lambda model, optimizer, loss, comm: (loss.backward(),
                                                  optimizer.step())
    elif fault == "half_codebook":
        # validation's codebook lookup searches the first half of the
        # codebook alone
        lookup = vqvae._lookup_nchw

        def half(z, codebook):
            return lookup(z, codebook[:codebook.shape[0] // 2])

        vqvae._lookup_nchw = half
    elif fault == "jax_in_a_rank":
        # rank 1 (or the only process) loads a module named ``jax``
        if not mesh.is_distributed() or mesh.process_index() == 1:
            sys.modules.setdefault("jax", types.ModuleType("jax"))
    else:
        raise ValueError(fault)


def state_unchanged_session(*args, **kw):
    plant("state_unchanged")
    return train.session(*args, **kw)


def half_batch_session(*args, **kw):
    plant("half_batch")
    return train.session(*args, **kw)


def no_exchange_session(*args, **kw):
    plant("no_exchange")
    return train.session(*args, **kw)


def half_codebook_session(*args, **kw):
    plant("half_codebook")
    return train.session(*args, **kw)


def jax_in_a_rank_session(*args, **kw):
    plant("jax_in_a_rank")
    return train.session(*args, **kw)
