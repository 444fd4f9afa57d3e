"""Keras-architecture U-Net, the exact graph of the reference's saved
models, as an ``nn.Module``: the port of
``dynamorph_tpu/models/unet_keras.py``.

The reference builds ``pre_conv`` (1x1, C -> 3) feeding
``segmentation_models.Unet('resnet34', decoder_block_type='upsampling',
decoder_filters=(256, 128, 64, 32, 16), decoder_use_batchnorm=True)``
(reference NNsegmentation/models.py:73-96, ``segmentation_models==1.0.1``).
Its encoder is classification_models' ResNet34, which differs from the
torchvision layout of ``models/unet.py``:

- a ``bn_data`` batch norm on the input with no trainable gamma (Keras
  ``scale=False``): its weight stays 1 and takes no gradient;
- pre-activation residual units (BN - ReLU - conv - BN - ReLU - conv, add),
  the first unit of every stage cut 'post': its 1x1 shortcut ``sc`` reads
  the BN-ReLU'd tensor, not the unit's input;
- a trailing ``bn1`` + ReLU after stage 4;
- the decoder's skips taken from ``stage{2,3,4}_unit1_relu1`` (each stage's
  first pre-activation) and ``relu0``;
- batch-norm eps 2e-5 in the encoder and Keras's 1e-3 in the decoder,
  momentum 0.01 in torch's convention (Keras's 0.99) everywhere.

Keras pads explicitly and convolves 'valid' (ZeroPadding2D + Conv2D), which
is torch's zero ``padding``; its zero-padded 3x3 stride-2 max-pool reads
post-ReLU values, so the -inf padding of ``stem_max_pool`` gives the same
result. Upsampling is nearest x2.

Submodules carry the Keras layer names (``conv0``, ``stage1_unit1_bn1``,
``decoder_stage0a_conv``, ``final_conv``, ...), so parameters are
``conv0.weight``, ``stage1_unit1_bn1.running_mean`` and so on, and the
``.h5`` import (``seg/keras_import.py``) is a name map. ``apply(x,
train)`` decides how batch norm runs (``models.common.batch_stats``).
"""
from __future__ import annotations

from typing import List, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from .common import batch_stats
from .unet import multislice_forward, stem_max_pool

_STAGES = ((3, 64), (4, 128), (6, 256), (3, 512))
_SKIP_CHANNELS = (256, 128, 64, 64, 0)
_ENC_EPS = 2e-5
_DEC_EPS = 1e-3
_BN_MOMENTUM = 0.01


def encoder_layer_names() -> List[str]:
    """Keras layer names of the encoder (``freeze_encoder``), as
    ``dynamorph_tpu/models/unet_keras.py:56-67`` lists them."""
    names = ["bn_data", "conv0", "bn0"]
    for si, (n_units, _) in enumerate(_STAGES):
        for u in range(n_units):
            base = f"stage{si + 1}_unit{u + 1}_"
            names += [base + "bn1", base + "conv1", base + "bn2",
                      base + "conv2"]
            if u == 0:
                names.append(base + "sc")
    names.append("bn1")
    return names


def _bn(n: int, eps: float) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(n, eps=eps, momentum=_BN_MOMENTUM)


class KerasUNet(nn.Module):
    """pre_conv + classification_models ResNet34 encoder + the sm 1.0.1
    upsampling decoder -> logits. ``forward`` takes (B, C, H, W) in [0, 1]
    (H, W multiples of 32) and returns (B, n_classes, H, W) logits."""

    def __init__(self, n_channels: int = 2, n_classes: int = 3,
                 decoder_filters: Sequence[int] = (256, 128, 64, 32, 16)):
        super().__init__()
        self.n_channels, self.n_classes = n_channels, n_classes
        self.decoder_filters = tuple(decoder_filters)
        self.pre_conv = nn.Conv2d(n_channels, 3, 1)
        self.bn_data = _bn(3, _ENC_EPS)
        self.bn_data.weight.requires_grad_(False)     # Keras scale=False
        self.conv0 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn0 = _bn(64, _ENC_EPS)
        in_ch = 64
        for si, (n_units, ch) in enumerate(_STAGES):
            for u in range(n_units):
                base = f"stage{si + 1}_unit{u + 1}_"
                stride = 2 if (u == 0 and si > 0) else 1
                self.add_module(base + "bn1", _bn(in_ch, _ENC_EPS))
                self.add_module(base + "conv1", nn.Conv2d(
                    in_ch, ch, 3, stride, 1, bias=False))
                self.add_module(base + "bn2", _bn(ch, _ENC_EPS))
                self.add_module(base + "conv2", nn.Conv2d(
                    ch, ch, 3, 1, 1, bias=False))
                if u == 0:
                    self.add_module(base + "sc", nn.Conv2d(
                        in_ch, ch, 1, stride, 0, bias=False))
                in_ch = ch
        self.bn1 = _bn(512, _ENC_EPS)
        in_ch = 512
        for i, (f_out, skip) in enumerate(zip(self.decoder_filters,
                                              _SKIP_CHANNELS)):
            for half, cin in (("a", in_ch + skip), ("b", f_out)):
                name = f"decoder_stage{i}{half}"
                self.add_module(name + "_conv", nn.Conv2d(
                    cin, f_out, 3, 1, 1, bias=False))
                self.add_module(name + "_bn", _bn(f_out, _DEC_EPS))
            in_ch = f_out
        self.final_conv = nn.Conv2d(self.decoder_filters[-1], n_classes, 3,
                                    1, 1)
        self.eval()

    def encoder_parameters(self) -> List[nn.Parameter]:
        """The encoder's parameters (``freeze_encoder`` zeroes their
        gradients)."""
        return [p for name in encoder_layer_names()
                for p in getattr(self, name).parameters()]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        m = self._modules
        h = self.bn_data(self.pre_conv(x))
        relu0 = h = F.relu(self.bn0(self.conv0(h)))
        h = stem_max_pool(h)
        skips = []
        for si, (n_units, _) in enumerate(_STAGES):
            for u in range(n_units):
                base = f"stage{si + 1}_unit{u + 1}_"
                pre = F.relu(m[base + "bn1"](h))
                shortcut = m[base + "sc"](pre) if u == 0 else h
                if u == 0 and si > 0:
                    skips.append(pre)
                y = F.relu(m[base + "bn2"](m[base + "conv1"](pre)))
                h = m[base + "conv2"](y) + shortcut
        h = F.relu(self.bn1(h))
        for i, skip in enumerate(skips[::-1] + [relu0, None]):
            h = F.interpolate(h, scale_factor=2, mode="nearest")
            if skip is not None:
                h = torch.cat([h, skip], dim=1)
            for half in "ab":
                name = f"decoder_stage{i}{half}"
                h = F.relu(m[name + "_bn"](m[name + "_conv"](h)))
        return self.final_conv(h)

    def apply(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """Logits, with batch norm on the batch's statistics (and the
        running ones updated) when ``train``, else on the running ones."""
        with batch_stats(self, train):
            return self(x)


class MultiSliceKerasUNet(KerasUNet):
    """``models.unet.MultiSliceUNet`` with a ``KerasUNet`` body at
    ``n_classes=unet_feat``: the body over each slice of (B, C, Z, X, Y),
    its features merged to (B, Z * unet_feat, X, Y), then ``post_conv``
    (1x1 + ReLU) and ``pred_head`` (1x1) -> (B, n_classes, X, Y) logits
    (reference NNsegmentation/models.py:206-258)."""

    def __init__(self, n_channels: int = 2, n_slices: int = 5,
                 n_classes: int = 3, unet_feat: int = 32,
                 decoder_filters: Sequence[int] = (256, 128, 64, 32, 16)):
        super().__init__(n_channels, unet_feat, decoder_filters)
        self.unet_feat = unet_feat
        self.post_conv = nn.Conv2d(n_slices * unet_feat, unet_feat, 1)
        self.pred_head = nn.Conv2d(unet_feat, n_classes, 1)
        self.n_classes = n_classes
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return multislice_forward(self, super().forward, x)
