"""ResNet34-encoder U-Net for 3-class semantic segmentation, as an
``nn.Module`` — the port of ``dynamorph_tpu/models/unet.py``.

The network: a 1x1 ``pre_conv`` (C -> 3, with bias), the ResNet34 encoder
(7x7 stride-2 stem, batch norm, ReLU, 3x3 stride-2 max-pool, 3/4/6/3 basic
blocks), five decoder blocks (nearest 2x upsample, concat
``[upsampled, skip]``, conv-BN-ReLU twice; widths 256, 128, 64, 32, 16)
and a 3x3 ``segmentation_head`` with bias. Input (B, C, H, W) in [0, 1],
output (B, n_classes, H, W) logits; H and W multiples of 32.

Parameter names follow ``segmentation_models_pytorch``'s
``Unet("resnet34")`` layout (``encoder.*`` as torchvision's resnet34,
``decoder.blocks.{i}.conv{1,2}.{0,1}``, ``segmentation_head.0``) plus the
``pre_conv.*`` the JAX net adds. Nothing here was checked against that
package: the names are its public layout, and the JAX weights cross through
``models.jax_import.state_dict_from_jax(..., network="UNet")``.

``apply(x, train)`` decides how batch norm runs, whatever the module's
own mode (``models.common.batch_stats``): with ``train=False`` it uses the
running statistics, ``(x - mean) / sqrt(var + 1e-5) * weight + bias`` as
``dynamorph_tpu/nn/functional.py:175-179``; with ``train=True`` torch's
batch norm is the JAX package's (:146-180): biased batch statistics for
the output, the unbiased variance folded into the running one, momentum
0.1. The JAX package takes the batch statistics in one pass shifted by the
running mean and torch in two, which moves them by about 1e-6.

``MultiSliceUNet`` is the 2.5-D body of ``SegmentWithMultipleSlice``
(``dynamorph_tpu/seg/model.py:339-417``) and ``weighted_ce_loss`` the
training loss (``dynamorph_tpu/models/unet.py:186-198``).
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

from .common import batch_stats

# ResNet34 stages: (n_blocks, channels)
_STAGES = ((3, 64), (4, 128), (6, 256), (3, 512))
# skip channels met by decoder blocks 0-4 (strides 16, 8, 4, 2, none)
_SKIP_CHANNELS = (256, 128, 64, 64, 0)


class BasicBlock(nn.Module):
    """ResNet basic block (``_apply_basic_block``, unet.py:51-63): conv3x3
    (stride) - BN - ReLU - conv3x3 - BN, plus the identity or a 1x1
    ``downsample`` conv + BN where the stride or the width changes."""

    def __init__(self, in_ch: int, out_ch: int, stride: int):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(out_ch)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(out_ch)
        self.downsample = None
        if stride != 1 or in_ch != out_ch:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_ch, out_ch, 1, stride, 0, bias=False),
                nn.BatchNorm2d(out_ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x)))
        h = self.bn2(self.conv2(h))
        sc = x if self.downsample is None else self.downsample(x)
        return F.relu(h + sc)


def stem_max_pool(h: torch.Tensor) -> torch.Tensor:
    """The ResNet stem's 3x3 stride-2 max-pool, padded with -inf as the
    JAX reduce_window (unet.py:66-69)."""
    return F.max_pool2d(h, 3, 2, 1)


class ResNet34Encoder(nn.Module):
    """Stem + layer1..4; returns the bottleneck and the skips at strides
    2, 4, 8 and 16 (``UNet._encode``, unet.py:132-153)."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        in_ch = 64
        for si, (n_blocks, ch) in enumerate(_STAGES):
            blocks = []
            for b in range(n_blocks):
                blocks.append(BasicBlock(in_ch, ch,
                                         2 if (b == 0 and si > 0) else 1))
                in_ch = ch
            setattr(self, f"layer{si + 1}", nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor):
        h = F.relu(self.bn1(self.conv1(x)))
        skips = [h]
        h = stem_max_pool(h)
        for i in range(1, 5):
            h = getattr(self, f"layer{i}")(h)
            if i < 4:
                skips.append(h)
        return h, skips


def _conv_bn_relu(in_ch: int, out_ch: int) -> nn.Sequential:
    return nn.Sequential(nn.Conv2d(in_ch, out_ch, 3, 1, 1, bias=False),
                         nn.BatchNorm2d(out_ch), nn.ReLU())


class DecoderBlock(nn.Module):
    def __init__(self, in_ch: int, skip_ch: int, out_ch: int):
        super().__init__()
        self.conv1 = _conv_bn_relu(in_ch + skip_ch, out_ch)
        self.conv2 = _conv_bn_relu(out_ch, out_ch)

    def forward(self, x: torch.Tensor, skip=None) -> torch.Tensor:
        # jnp.repeat on both axes (unet.py:72-74) is nearest 2x
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        if skip is not None:
            x = torch.cat([x, skip], dim=1)
        return self.conv2(self.conv1(x))


class _Decoder(nn.Module):
    def __init__(self, filters: Sequence[int]):
        super().__init__()
        in_chs = (512,) + tuple(filters[:-1])
        self.blocks = nn.ModuleList([
            DecoderBlock(i, s, f)
            for i, s, f in zip(in_chs, _SKIP_CHANNELS, filters)])


class UNet(nn.Module):
    """pre_conv(1x1, C -> 3) + ResNet34 encoder + upsampling decoder ->
    logits. ``forward`` takes (B, C, H, W) in [0, 1] and returns
    (B, n_classes, H, W) logits."""

    def __init__(self, n_channels: int = 2, n_classes: int = 3,
                 decoder_filters: Sequence[int] = (256, 128, 64, 32, 16)):
        super().__init__()
        self.n_channels, self.n_classes = n_channels, n_classes
        self.pre_conv = nn.Conv2d(n_channels, 3, 1)
        self.encoder = ResNet34Encoder()
        self.decoder = _Decoder(decoder_filters)
        self.segmentation_head = nn.Sequential(
            nn.Conv2d(decoder_filters[-1], n_classes, 3, 1, 1))
        self.eval()

    def encoder_parameters(self):
        """The encoder's parameters (``freeze_encoder`` zeroes their
        gradients)."""
        return list(self.encoder.parameters())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, skips = self.encoder(self.pre_conv(x))
        for block, skip in zip(self.decoder.blocks,
                               skips[::-1] + [None]):
            h = block(h, skip)
        return self.segmentation_head(h)

    def apply(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """Logits, with batch norm on the batch's statistics (and the
        running ones updated) when ``train``, else on the running ones."""
        with batch_stats(self, train):
            return self(x)


class MultiSliceUNet(UNet):
    """The U-Net over each slice of a (B, C, Z, X, Y) input at
    ``n_classes=unet_feat`` (SplitSlice), its features merged back to
    (B, Z * unet_feat, X, Y) (MergeSlices), then ``post_conv`` (1x1 + ReLU)
    and ``pred_head`` (1x1) -> (B, n_classes, X, Y) logits (reference
    NNsegmentation/models.py:206-258)."""

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


def multislice_forward(net: nn.Module, body,
                       x: torch.Tensor) -> torch.Tensor:
    """SplitSlice -> ``body`` -> MergeSlices -> ``net.post_conv`` + ReLU ->
    ``net.pred_head``, for a (B, C, Z, X, Y) input."""
    b, c, z, xs, ys = x.shape
    feats = body(x.transpose(1, 2).reshape(b * z, c, xs, ys))
    merged = feats.reshape(b, z * net.unet_feat, xs, ys)
    return net.pred_head(F.relu(net.post_conv(merged)))


def weighted_ce_loss(logits: torch.Tensor,
                     labels_with_weight: torch.Tensor) -> torch.Tensor:
    """Weighted per-pixel softmax cross-entropy on logits, averaged over
    the batch's pixels (reference NNsegmentation/layers.py:89-115).

    ``labels_with_weight``: (B, n_classes + 1, H, W), the (possibly soft)
    labels then the per-pixel weight."""
    w = labels_with_weight[:, -1]
    y = labels_with_weight[:, :-1]
    ce = -torch.sum(y * torch.log_softmax(logits, dim=1), dim=1)
    return torch.mean(ce * w)
