"""The U-Net segmentation path on the card against the port's CPU path:
the network on full-width 256 x 256 tiles, direct mode at 128 x 128 and the
tiled ensemble under one numpy RandomState. Card and CPU both run full fp32
(``fp32_strict``: no TF32 in cuDNN), so the probabilities agree within
1e-4; TF32 would show as about 1e-3.

Slice H: ``warp_affine`` at its four dtypes (both of cv2's arithmetics)
equal card vs CPU; a fit step (batch 2, 64 x 64) card vs CPU, each held
against float64 on its own side of every ReLU and the stem's max-pool
(``chip_smoke.kink_branches``): the card's gradient error at most 3 x the
CPU's plus 1e-5 (relative L2 per weight), beside a TF32 control that must
land above it; and the validation metrics card vs CPU within 1e-12.

This file imports neither jax nor the JAX package, so it also runs on a GPU
host without them:
``python -m pytest --noconftest tests/test_torch_segmentation_cuda.py``.
Without a card every test skips.
"""
import copy
import os
import sys

import numpy as np
import pytest
import torch
from torch import nn

from dynamorph_tpu_torch.seg.inference import predict_whole_map
from dynamorph_tpu_torch.seg.model import Segment

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import unet_step_grads  # noqa: E402

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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,cn", [(torch.float64, 2), (torch.float32, 1),
                                      (torch.float32, 2), (torch.uint16, 1),
                                      (torch.uint16, 2), (torch.uint8, 1)])
def test_warp_affine_card_vs_cpu(cuda, dtype, cn, monkeypatch):
    """The extraction's warp (364 x 364, seeded angles about the centre),
    in chunks of 5, bit-equal on the card and the CPU."""
    from dynamorph_tpu_torch.ops import geometry
    from dynamorph_tpu_torch.ops.geometry import rotation_matrix_2d, \
        warp_affine

    monkeypatch.setattr(geometry, "_CHUNK", 5)

    r = np.random.RandomState(6)
    w = 364
    src = torch.from_numpy(r.rand(12, w, w, cn) * 250).to(dtype)
    Ms = np.stack([rotation_matrix_2d((w / 2, w / 2), a, 1)
                   for a in r.uniform(-90, 90, 12)])
    card = warp_affine(src.to(cuda), Ms, (w, w)).cpu()
    cpu = warp_affine(src, Ms, (w, w))
    assert card.dtype == dtype and torch.equal(card, cpu)


@pytest.mark.cuda
def test_fit_step_card_vs_cpu(cuda):
    """One fit step's loss (rtol 1e-4) and gradients card vs CPU, held
    against float64 with the kinks replayed, beside a TF32 control."""
    base, _ = _models(window=64, seed=7)
    base = base.net.cpu()
    r = np.random.RandomState(8)
    x = torch.from_numpy(r.rand(2, 2, 64, 64).astype(np.float32))
    lab = r.rand(2, 3, 64, 64) ** 3
    lab /= lab.sum(1, keepdims=True)
    y = torch.from_numpy(np.concatenate([lab, np.ones((2, 1, 64, 64))], 1)
                         .astype(np.float32))

    def run(dev, dtype, fp32=True, masks=None, replay=False):
        net = copy.deepcopy(base).to(device=dev, dtype=dtype)
        return unet_step_grads(torch, net, x.to(dev, dtype), y.to(dev, dtype),
                               fp32, masks, replay)

    m_card, m_cpu = [], []
    l_card, g_card = run(cuda, torch.float32, masks=m_card)
    l_cpu, g_cpu = run("cpu", torch.float32, masks=m_cpu)
    _, f_card = run("cpu", torch.float64, masks=m_card, replay=True)
    _, f_cpu = run("cpu", torch.float64, masks=m_cpu, replay=True)
    _, g_tf32 = run(cuda, torch.float32, fp32=False)
    assert abs(l_card - l_cpu) <= 1e-4 * abs(l_cpu)

    def err(g, f, n):
        return float(torch.norm(g[n] - f[n]) / torch.norm(f[n]))

    def ratio(g):
        return max(err(g, f_card, n) / (3.0 * err(g_cpu, f_cpu, n) + 1e-5)
                   for n in f_card)

    assert ratio(g_card) <= 1
    assert ratio(g_tf32) > 1


@pytest.mark.cuda
def test_validation_metrics_card_vs_cpu(cuda):
    from dynamorph_tpu_torch.seg.metrics import f1_score, roc_auc_score

    r = np.random.RandomState(9)
    truth = torch.from_numpy(r.rand(8, 256, 256) > 0.7)
    score = torch.from_numpy((r.randn(8, 256, 256) + truth.numpy())
                             .astype(np.float32))
    score[0, :10] = 0.25                       # a run of ties
    for fn, s in ((roc_auc_score, score), (f1_score, score > 0.5)):
        assert abs(fn(truth.to(cuda), s.to(cuda)) - fn(truth, s)) <= 1e-12
