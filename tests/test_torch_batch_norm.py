"""The port's ``BatchNorm2d`` (``nn/batchnorm.py``: torch's, with a following
ReLU folded in) and ``ops/batch_norm.py``'s dispatch on the CPU, where every
training-mode batch norm takes ``F.batch_norm``: bit-equal to
``nn.BatchNorm2d`` (+ ``nn.ReLU``) in outputs, gradients and running
buffers, in training and eval; the VQ-VAEs' ``state_dict`` names and their
training step bit-equal to the layout with separate ReLUs; the counters.

The kernels themselves run only on the card:
``tests/test_torch_batch_norm_cuda.py``. The cross-rank batch norm with a
folded ReLU is ``tests/test_torch_sharded_loss.py``'s
``test_cross_rank_batch_norm_is_the_global_batch_norm[folded]``.
"""
import copy

import numpy as np
import pytest
import torch
from torch import nn

from dynamorph_tpu_torch.models import (AAEModel, IWAEModel, VAEModel,
                                        VQVAEz16, VQVAEz32)
from dynamorph_tpu_torch.nn.batchnorm import BatchNorm2d
from dynamorph_tpu_torch.ops import batch_norm as bn_ops

SMALL = dict(num_hiddens=8, num_residual_hiddens=8, num_embeddings=16)
# (training-mode batch norms, of them with a folded ReLU) a model holds
FOLDS = {VQVAEz32: (11, 6), VQVAEz16: (8, 5), VAEModel: (8, 5),
         IWAEModel: (8, 5), AAEModel: (8, 5)}


def _pair(c, relu, momentum, seed):
    """The port's module and torch's (with its ReLU) at the same weights
    and running buffers, moved off the identity."""
    g = torch.Generator().manual_seed(seed)
    new = BatchNorm2d(c, relu=relu, momentum=momentum)
    old = nn.BatchNorm2d(c, momentum=momentum)
    with torch.no_grad():
        new.weight.copy_(0.5 + torch.rand(c, generator=g))
        new.bias.copy_(torch.randn(c, generator=g) * 0.5)
        new.running_mean.copy_(torch.randn(c, generator=g))
        new.running_var.copy_(0.5 + torch.rand(c, generator=g))
    old.load_state_dict(new.state_dict())
    return new, nn.Sequential(old, nn.ReLU()) if relu else old


def _run(module, x, dy, train):
    x = x.clone().requires_grad_(True)
    module.train(train)
    ys = [module(x) for _ in range(2)]     # the running buffers move twice
    (sum(ys) * dy).sum().backward()
    return ys + [x.grad] + [p.grad for p in module.parameters()] + \
        list(module.state_dict().values())


@pytest.mark.parametrize("shape", [(6, 3, 5, 5), (1, 4, 3, 7), (5, 2, 1, 1)])
@pytest.mark.parametrize("momentum", [0.1, None])
@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("relu", [False, True])
def test_module_is_torch_batch_norm(relu, train, momentum, shape):
    """Outputs, input and parameter gradients, running buffers and
    ``num_batches_tracked`` bit-equal to ``nn.BatchNorm2d`` (then
    ``nn.ReLU``), the inputs off centre (mean 3, std 2)."""
    r = np.random.RandomState(sum(shape))
    x = torch.from_numpy((r.randn(*shape) * 2 + 3).astype(np.float32))
    dy = torch.from_numpy(r.randn(*shape).astype(np.float32))
    new, old = _pair(shape[1], relu, momentum, seed=len(shape))
    for a, b in zip(_run(new, x, dy, train), _run(old, x, dy, train),
                    strict=True):
        assert torch.equal(a, b)
    assert ("relu=True" in repr(new)) == relu


def test_one_value_a_channel_is_refused_as_by_torch():
    new, old = _pair(3, True, 0.1, seed=0)
    x = torch.randn(1, 3, 1, 1)
    for m in (new, old):
        with pytest.raises(ValueError, match="more than 1 value"):
            m.train()(x)


@pytest.mark.parametrize("kw", [dict(affine=False),
                                dict(track_running_stats=False)],
                         ids=["no_affine", "no_running_stats"])
def test_module_refuses_what_the_kernels_do_not_keep(kw):
    """The kernels apply gamma and beta and update running statistics, so
    the module is built with both or not at all."""
    with pytest.raises(ValueError, match="affine=True"):
        BatchNorm2d(3, **kw)


def test_counters_on_the_cpu():
    """A training-mode batch norm on the CPU is a fallback, never a
    launch; eval mode counts in neither."""
    m = BatchNorm2d(3, relu=True)
    x = torch.randn(4, 3, 5, 5)
    counters = bn_ops.batch_norm_train

    def read():
        return counters.launches, counters.fallbacks

    launches, fallbacks = read()
    m.train()(x)
    m.eval()(x)
    assert read() == (launches, fallbacks + 1)


def _unfolded(model):
    """A copy of ``model`` in the layout with separate ReLUs: each port
    ``BatchNorm2d`` an ``nn.BatchNorm2d`` with its state, and the
    ``nn.Identity`` after a folded one an ``nn.ReLU``."""
    old = copy.deepcopy(model)
    seqs = [m for m in old.modules() if isinstance(m, nn.Sequential)]
    for seq in seqs:
        for i, m in enumerate(list(seq)):
            if isinstance(m, BatchNorm2d):
                bn = nn.BatchNorm2d(m.num_features, eps=m.eps,
                                    momentum=m.momentum)
                bn.load_state_dict(m.state_dict())
                bn.train(m.training)
                seq[i] = bn
                if m.relu:
                    assert isinstance(seq[i + 1], nn.Identity)
                    seq[i + 1] = nn.ReLU()
    assert not any(isinstance(m, BatchNorm2d) for m in old.modules())
    return old


@pytest.mark.parametrize("cls", list(FOLDS), ids=lambda c: c.__name__)
def test_state_dict_names_and_strict_load(cls):
    """The same ``state_dict`` names, in the same order, as the layout
    with separate ReLUs (the reference's), and a strict load both ways;
    every batch norm of the trunks is the port's, the folded ones where a
    ReLU followed."""
    torch.manual_seed(0)
    model = cls(**{k: v for k, v in SMALL.items()
                   if k != "num_embeddings" or cls in (VQVAEz16, VQVAEz32)})
    old = _unfolded(model)
    assert list(model.state_dict()) == list(old.state_dict())
    model.load_state_dict(old.state_dict(), strict=True)
    old.load_state_dict(model.state_dict(), strict=True)
    ours = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
    assert (len(ours), sum(m.relu for m in ours)) == FOLDS[cls]


@pytest.mark.parametrize("cls", [VQVAEz32, VQVAEz16],
                         ids=lambda c: c.__name__)
def test_vqvae_step_is_the_unfolded_step(cls):
    """Two training-mode ``apply`` calls with backward, then an eval
    ``apply``: losses, gradients and running buffers bit-equal to the
    layout with separate ReLUs, and the fallback counted once a batch norm
    a training pass."""
    torch.manual_seed(1)
    model = cls(**SMALL)
    with torch.no_grad():        # batch norm off the identity
        for m in model.modules():
            if isinstance(m, BatchNorm2d):
                m.weight.uniform_(0.5, 1.5)
                m.bias.uniform_(-0.5, 0.5)
    old = _unfolded(model)
    r = np.random.RandomState(2)
    x = torch.from_numpy(r.randn(6, 2, 32, 32).astype(np.float32))
    rel = torch.from_numpy(r.randint(0, 3, (6, 6)).astype(np.uint8))
    out = []
    for m in (model, old):
        before = bn_ops.batch_norm_train.fallbacks
        losses = []
        for _ in range(2):
            m.zero_grad()
            _, lo = m.apply(x, train=True, time_matching_mat=rel)
            lo["total_loss"].backward()
            losses.append({k: v.detach() for k, v in lo.items()})
        _, ev = m.apply(x, train=False, time_matching_mat=rel)
        out.append((losses, ev, [p.grad for p in m.parameters()],
                    list(m.state_dict().values()),
                    bn_ops.batch_norm_train.fallbacks - before))
    (l1, e1, g1, s1, f1), (l2, e2, g2, s2, f2) = out
    for a, b in zip(l1, l2, strict=True):
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(torch.equal(e1[k], e2[k]) for k in e1)
    for a, b in zip(g1 + s1, g2 + s2, strict=True):
        assert torch.equal(a, b)
    assert (f1, f2) == (2 * FOLDS[cls][0], 0)
