"""The VAE family and the ResNet/SimCLR encoders on the card against the
port's CPU path, at full width: the z16 widths of
configs/config_example.yml:61-65 (num_hiddens 16, num_residual_hiddens
32) on 2 x 128 x 128 patches, and ResNet50 (ResNet18 for the train step).

Tolerances: encodes within 1e-5 of max |z| (fp32 on both devices, cuDNN
against oneDNN summation order: measured 2-9e-7 of max |z| on an H100
80GB HBM3), and a TF32 control that must land above it (measured 1.3-6.6e-4 of
max |z|: at the 1e-4 that chip_smoke.py's earlier phases use for the
z16 VQ-VAE, TF32 on these narrow convolutions lands only 1.3-2.7x over);
one train step's losses card vs CPU within rtol 1e-4 (the fraction of
positive triplets within one triplet; the triplet loss against the
float64 miner on the card's embedding), and its gradients and a ResNet's
embedding, per tensor in relative L2, held against the same step in
float64 on the CPU taken on the fp32 step's side of every ReLU, triplet
hinge, max-pool and, with the hard-negative miner, of its two maxima and
its clamp (its choices replayed): the card at most 3 x the CPU's
error plus 1e-5 (chip_smoke.py phases 6 and 12), beside a control step
with TF32 on that must land above it. Against float64's own choices, one
element within rounding of a kink flips and moves whole gradients by
1e-4-1e-2 (tools/step_grad_witness.py). The
all-triplet miner at 768 patches within 1e-5 relative, its positive
fraction within one triplet.

This file imports neither jax nor the JAX package, so it also runs on a GPU
host without them:
``python -m pytest --noconftest tests/test_torch_models_cuda.py``.
Without a card every test skips.
"""
import copy
import os
import sys
from contextlib import nullcontext

import numpy as np
import pytest
import torch
from torch import nn

from dynamorph_tpu_torch.core.device import fp32_strict
from dynamorph_tpu_torch.models import AAEModel, IWAEModel, VAEModel
from dynamorph_tpu_torch.models.losses import AllTripletMiner
from dynamorph_tpu_torch.models.resnet_simclr import EncodeProject

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import kink_branches  # noqa: E402

Z16 = dict(num_hiddens=16, num_residual_hiddens=32)
ENCODE_ATOL = 1e-5
GRAD_VS_CPU, GRAD_FLOOR = 3.0, 1e-5
LOSS_RTOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: compares the card with the CPU")
    return torch.device("cuda")


def _model(name):
    """``ResNet18-hard``: ResNet18 with the hard-negative miner."""
    if name.startswith("ResNet"):
        return EncodeProject(arch=name.split("-")[0],
                             hard_negative=name.endswith("-hard"))
    return {"VAE": VAEModel, "IWAE": IWAEModel, "AAE": AAEModel}[name](**Z16)


def _build(name, seed=0):
    """A seeded model with batch norm moved off the identity."""
    torch.manual_seed(seed)
    model = _model(name)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.BatchNorm1d, nn.BatchNorm2d)):
                n = m.num_features
                m.running_mean.copy_(0.2 * torch.randn(n, generator=g))
                m.running_var.copy_(0.5 + torch.rand(n, generator=g))
                m.weight.copy_(0.7 + 0.6 * torch.rand(n, generator=g))
                if m.bias.requires_grad:
                    m.bias.copy_(0.2 * torch.randn(n, generator=g))
    return model


def _patches(n, seed=1):
    r = np.random.RandomState(seed)
    x = r.randn(n, 2, 128, 128).astype(np.float32)
    return torch.from_numpy(x)


def _encode(model, x):
    out = model.encode(x)
    return out if torch.is_tensor(out) else out[0]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["VAE", "IWAE", "AAE", "ResNet50"])
def test_encode_card_vs_cpu(cuda, name):
    cpu = _build(name)
    card = copy.deepcopy(cpu).to(cuda)
    x = _patches(16)
    z_cpu = _encode(cpu, x)
    z_card = _encode(card, x.to(cuda)).cpu()
    limit = ENCODE_ATOL * float(z_cpu.abs().max())
    err = float((z_card - z_cpu).abs().max())
    assert err <= limit, (err, limit)
    # control: the same forward outside fp32_strict, with TF32 on
    saved = torch.backends.cudnn.allow_tf32, \
        torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with torch.no_grad():
            xg = x.to(cuda)
            if name.startswith("ResNet"):
                z_tf32 = card._forward(xg, "z").cpu()
            else:
                z_tf32 = card.enc[2:](card.enc[1](card.enc[0](xg)))
                z_tf32 = z_tf32[:, :Z16["num_hiddens"]].cpu()
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = saved
    assert float((z_tf32 - z_cpu).abs().max()) > limit


def _step(model, x, labels=None, noise=None, strict=fp32_strict,
          masks=None, replay=False):
    """One train-mode forward and backward, both inside ``fp32_strict`` as
    the train step runs them (cuDNN reads the TF32 switch when each
    backward convolution is dispatched); returns (losses, grads), a
    ResNet's embedding among the grads as ``"embedding"``."""
    branches = nullcontext() if masks is None else \
        kink_branches(torch, masks, replay)
    with strict(), branches:
        if labels is not None:
            z, losses = model.apply(x, labels, train=True)
        else:
            z, losses = None, model.apply(x, train=True, **(noise or {}))[1]
        losses["total_loss"].backward()
    grads = {n: p.grad.detach().cpu().double()
             for n, p in model.named_parameters() if p.grad is not None}
    if z is not None:
        grads["embedding"] = z.detach().cpu().double()
    return {k: float(v.detach()) for k, v in losses.items()}, grads


@pytest.mark.cuda
@pytest.mark.parametrize("init", ["seeded", "default"])
@pytest.mark.parametrize("name", ["VAE", "IWAE", "AAE", "ResNet18",
                                  "ResNet18-hard"])
def test_train_step_card_vs_cpu(cuda, name, init, monkeypatch):
    """``seeded``: batch norm off the identity; ``default``: PyTorch's own
    init, as run_training starts (seed 3 of it flipped a residual ReLU on
    the card in tools/step_grad_witness.py's step). Each fp32 step is held
    against float64 on its own side of every kink (``kink_branches``: the
    ReLUs, the all-triplet hinge, the max-pool, and the hard-negative
    miner's two maxima and its clamp)."""
    if init == "seeded":
        base = _build(name, seed=2)
    else:
        torch.manual_seed(3)
        base = _model(name)
    x = _patches(16, seed=3)
    labels = torch.arange(16) // 4 if name.startswith("ResNet") else None
    g = torch.Generator().manual_seed(4)
    zshape = (16, Z16["num_hiddens"], 16, 16)
    noise = {}
    if name == "VAE":
        noise["eps"] = torch.randn(zshape, generator=g)
    if name == "IWAE":
        noise["fixed_eps"] = torch.randn((base.k,) + zshape, generator=g)

    def run(dev, dtype, strict=fp32_strict, masks=None, replay=False):
        model = copy.deepcopy(base).to(device=dev, dtype=dtype)
        return _step(model, x.to(dev, dtype),
                     labels=None if labels is None else labels.to(dev),
                     noise={k: v.to(dev, dtype) for k, v in noise.items()},
                     strict=strict, masks=masks, replay=replay)

    m_card, m_cpu = [], []
    runs = {"card": run(cuda, torch.float32, masks=m_card),
            "cpu": run("cpu", torch.float32, masks=m_cpu)}
    f64 = {"card": run("cpu", torch.float64, masks=m_card, replay=True),
           "cpu": run("cpu", torch.float64, masks=m_cpu, replay=True)}
    # control: the models' own fp32_strict blocks made no-ops, TF32 on
    from dynamorph_tpu_torch.models import losses, resnet_simclr, vae
    for mod in (losses, resnet_simclr, vae):
        monkeypatch.setattr(mod, "fp32_strict", nullcontext)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    runs["tf32"] = run(cuda, torch.float32, strict=nullcontext)
    f64["tf32"] = f64["card"]
    for k, v in runs["cpu"][0].items():
        card = runs["card"][0][k]
        if k == "positive_triplet":     # a count of hinges: one triplet
            assert abs(card - v) <= 1.0 / (16 * 3 * 12), (card, v)
            continue
        if labels is not None:
            # the triplet loss reads the embedding alone (held below, as a
            # gradient): the miner's own arithmetic, against float64 on
            # the card's embedding
            v = float(base.miner(labels, runs["card"][1]["embedding"])[0])
        assert abs(card - v) <= LOSS_RTOL * abs(v), (k, card, v)
    names = [n for n in runs["cpu"][1]
             if n.endswith(".weight") or n == "embedding"]

    def err(key, n):
        return float(torch.norm(runs[key][1][n] - f64[key][1][n])
                     / torch.norm(f64[key][1][n]))

    ratio = {key: max(err(key, n) / (GRAD_VS_CPU * err("cpu", n)
                                     + GRAD_FLOOR) for n in names)
             for key in ("card", "tf32")}
    assert ratio["card"] <= 1, ratio
    assert ratio["tf32"] > 1, ratio


@pytest.mark.cuda
def test_all_triplet_miner_at_768_card_vs_cpu(cuda):
    """The (B, B, B) miner at the config's 768 patches a step (192 anchors
    x 4): loss and positive fraction card vs CPU."""
    r = np.random.RandomState(5)
    emb = torch.from_numpy(r.randn(768, 128).astype(np.float32))
    ids = torch.arange(768) // 4
    miner = AllTripletMiner(margin=1.0)
    loss_cpu, f_cpu = miner(ids, emb)
    loss_card, f_card = miner(ids.to(cuda), emb.to(cuda))
    assert abs(float(loss_card) - float(loss_cpu)) <= 1e-5 * float(loss_cpu)
    n_val = 768 * 3 * 764
    assert abs(float(f_card) - float(f_cpu)) <= 1.0 / n_val + 1e-7
