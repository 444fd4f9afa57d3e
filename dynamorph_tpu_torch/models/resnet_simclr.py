"""ResNet encoder and SimCLR projection head for triplet representation
learning, as ``nn.Module``s — the port of
``dynamorph_tpu/models/resnet_simclr.py`` (reference
HiddenStateExtractor/resnet.py).

``EncodeProject`` is a torchvision ResNet18/50/101/152 trunk without its
classifier (2-channel stem: 7x7 stride 2 and a 3x3 stride-2 max-pool, or
the 3x3 stride-1 ``cifar_head``), global average pooling, and the 128-d
projection head fc(no bias) - BN - ReLU - fc(no bias) - BN(no bias)
(:99-107). Parameter names are torchvision's under ``convnet.`` plus
``projection.{fc1,bn1,fc2,bn2}``
(``dynamorph_tpu/models/torch_import.py:202-272``), so a reference
``model.pt`` loads with ``strict=True``. The basic block and the stem's
max-pool are those of ``models/unet.py``.

``train`` decides how batch norm runs (``models/common.batch_stats``), and
the passes run under ``core.device.fp32_strict``.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..core.device import fp32_strict
from ..core.mesh import (all_gather_cat, batches_over_devices,
                         fan_out_devices, replica)
from .common import batch_stats
from .losses import AllTripletMiner, HardNegativeTripletMiner
from .unet import BasicBlock, stem_max_pool

# arch: (block, blocks per stage, encoder width)
_ARCHS = {
    "ResNet18": ("basic", (2, 2, 2, 2), 512),
    "ResNet50": ("bottleneck", (3, 4, 6, 3), 2048),
    "ResNet101": ("bottleneck", (3, 4, 23, 3), 2048),
    "ResNet152": ("bottleneck", (3, 8, 36, 3), 2048),
}
_WIDTHS = (64, 128, 256, 512)


class Bottleneck(nn.Module):
    """torchvision's bottleneck (``_apply_bottleneck``,
    dynamorph_tpu/models/resnet_simclr.py:56-72): 1x1 - BN - ReLU - 3x3
    (stride) - BN - ReLU - 1x1 (x4 width) - BN, plus the identity or a 1x1
    ``downsample`` conv + BN, then ReLU."""

    expansion = 4

    def __init__(self, in_ch: int, mid_ch: int, stride: int):
        super().__init__()
        out_ch = mid_ch * self.expansion
        self.conv1 = nn.Conv2d(in_ch, mid_ch, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(mid_ch)
        self.conv2 = nn.Conv2d(mid_ch, mid_ch, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(mid_ch)
        self.conv3 = nn.Conv2d(mid_ch, out_ch, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(out_ch)
        self.downsample = None
        if stride != 1 or in_ch != out_ch:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_ch, out_ch, 1, stride, 0, bias=False),
                nn.BatchNorm2d(out_ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        sc = x if self.downsample is None else self.downsample(x)
        return F.relu(h + sc)


class ResNetTrunk(nn.Module):
    """Stem + layer1..4 + global average pool: (B, C, H, W) -> (B,
    encoder width)."""

    def __init__(self, arch: str, num_inputs: int, cifar_head: bool):
        super().__init__()
        block, layers, _ = _ARCHS[arch]
        self.cifar_head = cifar_head
        if cifar_head:
            self.conv1 = nn.Conv2d(num_inputs, 64, 3, 1, 1, bias=False)
        else:
            self.conv1 = nn.Conv2d(num_inputs, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        in_ch = 64
        for si, (n_blocks, width) in enumerate(zip(layers, _WIDTHS)):
            blocks = []
            for b in range(n_blocks):
                stride = 2 if (b == 0 and si > 0) else 1
                if block == "basic":
                    blocks.append(BasicBlock(in_ch, width, stride))
                    in_ch = width
                else:
                    blocks.append(Bottleneck(in_ch, width, stride))
                    in_ch = width * Bottleneck.expansion
            setattr(self, f"layer{si + 1}", nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x)))
        if not self.cifar_head:
            h = stem_max_pool(h)
        for i in range(1, 5):
            h = getattr(self, f"layer{i}")(h)
        return torch.mean(h, dim=(2, 3))


class BatchNorm1dNoBias(nn.BatchNorm1d):
    """``BatchNorm1d`` whose offset stays at 0 (reference resnet.py:65-68):
    it is in the ``state_dict`` but takes no gradient."""

    def __init__(self, num_features: int):
        super().__init__(num_features)
        self.bias.requires_grad_(False)


class Projection(nn.Module):
    """fc(no bias) - BN - ReLU - fc(no bias) - BN(no bias)."""

    def __init__(self, enc_dim: int, proj_dim: int):
        super().__init__()
        self.fc1 = nn.Linear(enc_dim, enc_dim, bias=False)
        self.bn1 = nn.BatchNorm1d(enc_dim)
        self.fc2 = nn.Linear(enc_dim, proj_dim, bias=False)
        self.bn2 = BatchNorm1dNoBias(proj_dim)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return self.bn2(self.fc2(F.relu(self.bn1(self.fc1(h)))))


class EncodeProject(nn.Module):
    """ResNet encoder + projection head (reference resnet.py:70-127).

    ``encode(x, out="h" | "z")`` gives the pooled encoder features or the
    projection; ``apply(x, labels, train)`` the triplet loss on the
    projection. Ends its ``__init__`` in eval mode."""

    def __init__(self, arch: str = "ResNet50", num_inputs: int = 2,
                 cifar_head: bool = False, margin: float = 1.0,
                 proj_dim: int = 128, hard_negative: bool = False):
        super().__init__()
        if arch not in _ARCHS:
            raise NotImplementedError(
                f"arch {arch!r}; available: {sorted(_ARCHS)}")
        self.arch = arch
        self.num_inputs = num_inputs
        self.margin = margin
        self.hard_negative = hard_negative
        self.encoder_dim = _ARCHS[arch][2]
        self.convnet = ResNetTrunk(arch, num_inputs, cifar_head)
        self.projection = Projection(self.encoder_dim, proj_dim)
        self.miner = (HardNegativeTripletMiner if hard_negative
                      else AllTripletMiner)(margin=margin)
        self.eval()

    def _forward(self, x: torch.Tensor, out: str) -> torch.Tensor:
        if out not in ("h", "z"):
            raise ValueError(f'"out" can only be "h" or "z", not {out}')
        h = self.convnet(x)
        return h if out == "h" else self.projection(h)

    def encode(self, x: torch.Tensor, out: str = "z") -> torch.Tensor:
        """(B, C, H, W) -> h (B, encoder width) or z (B, proj_dim), with
        the running batch-norm statistics."""
        with torch.no_grad(), fp32_strict(), batch_stats(self, False):
            return self._forward(x, out)

    def apply(self, x: torch.Tensor, labels, train: bool = False):
        """Triplet-loss forward (reference resnet.py:119-126): returns (z,
        losses). ``positive_triplet`` (the fraction of valid triplets with
        a positive hinge) is left out for the hard-negative miner, which
        has none. Under a data-parallel step the miner sees the global
        batch: every rank's embeddings (with their gradient) and labels are
        gathered first, as the JAX step's miner sees the whole sharded
        batch."""
        with torch.set_grad_enabled(train), fp32_strict(), \
                batch_stats(self, train):
            z = self._forward(x, "z")
            labels = torch.as_tensor(labels, device=z.device)
            loss, f_pos = self.miner(all_gather_cat(labels),
                                     all_gather_cat(z))
        losses = {"total_loss": loss}
        if f_pos is not None:
            losses["positive_triplet"] = f_pos
        return z, losses

    def encode_batched(self, dataset: np.ndarray, out: str = "z",
                       batch_size: int = 512,
                       devices=None) -> np.ndarray:
        """(N, C, H, W) host patches -> (N, width) float32 on the host, in
        batches of ``batch_size`` on the model's device (the running
        statistics make each row's output its own).

        With several ``devices`` (default: this process's cards when the
        model is on the card) each batch fans out over them, a replica of
        the model a device (``core.mesh.batches_over_devices``;
        dynamorph_tpu/models/resnet_simclr.py:203-222)."""
        if not len(dataset):
            raise ValueError("encode_batched: empty dataset")
        devices = fan_out_devices(devices, next(self.parameters()).device)
        if len(devices) > 1:
            return batches_over_devices(lambda m, x: m.encode(x, out), self,
                                        dataset, batch_size, devices)
        model = replica(self, devices[0])
        outs = [model.encode(torch.from_numpy(np.asarray(
                    dataset[i: i + batch_size], dtype=np.float32)).to(
                        devices[0]), out)
                for i in range(0, len(dataset), batch_size)]
        return torch.cat(outs).cpu().numpy()


class LogisticRegression(nn.Module):
    """Linear probe (reference resnet.py:129-143), zero-initialised."""

    def __init__(self, input_dim: int = 128, n_class: int = 2):
        super().__init__()
        self.linear = nn.Linear(input_dim, n_class)
        nn.init.zeros_(self.linear.weight)
        nn.init.zeros_(self.linear.bias)

    def apply(self, x: torch.Tensor, labels: torch.Tensor,
              train: bool = False):
        """(logits, {"total_loss": cross-entropy, "acc": accuracy})."""
        with torch.set_grad_enabled(train), fp32_strict():
            z = self.linear(x)
            loss = F.cross_entropy(z, labels)
        acc = torch.mean((torch.argmax(z, 1) == labels).to(torch.float32))
        return z, {"total_loss": loss, "acc": acc}
