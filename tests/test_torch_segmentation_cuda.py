"""The U-Net segmentation path on the card against the port's CPU path:
the network on full-width 256 x 256 tiles, direct mode at 128 x 128 and the
tiled ensemble under one numpy RandomState. Card and CPU both run full fp32
(``fp32_strict``: no TF32 in cuDNN), so the probabilities agree within
1e-4; TF32 would show as about 1e-3.

This file imports neither jax nor the JAX package, so it also runs on a GPU
host without them:
``python -m pytest --noconftest tests/test_torch_segmentation_cuda.py``.
Without a card every test skips.
"""
import numpy as np
import pytest
import torch
from torch import nn

from dynamorph_tpu_torch.seg.inference import predict_whole_map
from dynamorph_tpu_torch.seg.model import Segment

PROB_ATOL = 1e-4
WINDOW = 256


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: compares the card with the CPU")
    return torch.device("cuda")


def _models(window=WINDOW, seed=0):
    """(card model, CPU model) on the same seeded weights, batch norm moved
    off the identity and the head scaled so the logits are O(1)."""
    cpu = Segment(input_shape=(2, window, window), seed=seed, device="cpu")
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in cpu.net.modules():
            if isinstance(m, nn.BatchNorm2d):
                n = m.num_features
                m.running_mean.copy_(0.2 * torch.randn(n, generator=g))
                m.running_var.copy_(0.5 + torch.rand(n, generator=g))
                m.weight.copy_(0.7 + 0.6 * torch.rand(n, generator=g))
                m.bias.copy_(0.2 * torch.randn(n, generator=g))
        cpu.net.segmentation_head[0].weight.mul_(30.0)
    card = Segment(input_shape=(2, window, window), device="cuda")
    card.net.load_state_dict(cpu.net.state_dict(), strict=True)
    return card, cpu


class _Recorder:
    def __init__(self, seed):
        self.rs, self.draws = np.random.RandomState(seed), []

    def randint(self, lo, hi):
        v = self.rs.randint(lo, hi)
        self.draws.append(v)
        return v


@pytest.mark.cuda
def test_unet_tiles_card_vs_cpu(cuda):
    card, cpu = _models()
    x = (np.random.RandomState(1).rand(4, 2, WINDOW, WINDOW) * 65535)
    pc, pg = cpu.predict_raw(x.astype(np.float32)), \
        card.predict_raw(x.astype(np.float32))
    assert pg.shape == (4, 3, 1, WINDOW, WINDOW)
    assert np.isfinite(pg).all()
    assert np.abs(pg - pc).max() <= PROB_ATOL
    assert pc.max() > 0.6                  # not a flat 1/3 everywhere


@pytest.mark.cuda
def test_direct_mode_card_vs_cpu(cuda):
    card, cpu = _models()
    stack = np.random.RandomState(2).rand(2, 2, 1, 128, 128) * 65535
    pc = predict_whole_map(stack, cpu, mode="direct")
    pg = predict_whole_map(stack, card, mode="direct")
    assert pg.shape == pc.shape == (2, 3, 1, 128, 128)
    assert np.abs(pg - pc).max() <= PROB_ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float64, np.uint16])
def test_tiled_ensemble_card_vs_cpu(cuda, dtype):
    """The same offsets from one RandomState seed, and the same merged
    probabilities; uint16 stacks upload as they are and scale on the card."""
    card, cpu = _models()
    stack = (np.random.RandomState(3).rand(1, 2, 1, 2 * WINDOW, 2 * WINDOW)
             * 65535).astype(dtype)
    rc, rg = _Recorder(0), _Recorder(0)
    pc = predict_whole_map(stack, cpu, n_supp=2, rng=rc)
    pg = predict_whole_map(stack, card, n_supp=2, rng=rg)
    assert rg.draws == rc.draws and len(rg.draws) == 4
    assert pg.shape == pc.shape == (1, 3, 1, 2 * WINDOW, 2 * WINDOW)
    assert pg.dtype == np.float64 and not (pg == -1).any()
    assert np.abs(pg - pc).max() <= PROB_ATOL
