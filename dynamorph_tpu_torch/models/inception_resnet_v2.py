"""InceptionResNetV2 trunk, the reference's second ImageNet baseline, as an
``nn.Module``: the port of ``dynamorph_tpu/models/inception_resnet_v2.py``.

The graph is keras_applications' ``InceptionResNetV2(include_top=False)``
(reference HiddenStateExtractor/naive_imagenet.py:47-60):

- the stem: five convs (valid but the third) and two valid 3x3 stride-2
  max-pools -> 192 channels;
- ``mixed_5b``: four branches, one a 3x3 'same' average pool that counts
  only the in-bounds taps -> 320;
- 10 block35 residual blocks (scale 0.17), ``mixed_6a`` -> 1088;
- 20 block17 blocks (scale 0.10, 1x7 / 7x1 factorised convs), ``mixed_7a``
  -> 2080;
- 9 block8 blocks (scale 0.20) and a last block8 at 1.0 with no
  activation, then ``conv_7b`` -> 1536, and with ``pooling="avg"`` the
  global average.

Every conv but the blocks' up-projections is a bias-free conv, a batch norm
with ``scale=False`` (weight fixed at 1, absent from Keras files) and eps
1e-3, and a ReLU; the up-projections ``<block>_conv`` carry a bias and no
batch norm. Submodules carry the Keras names of a fresh session
(``conv2d``, ``conv2d_1``, ..., ``batch_normalization_N``,
``block35_1_conv``, ``conv_7b``, ``conv_7b_bn``), numbered in creation
order, so ``import_keras_inception_resnet_v2`` maps a weight file by name,
or by position where its numbering starts at an offset.

``init(seed)`` draws every kernel glorot-uniform from
``np.random.RandomState(seed)`` in creation order, as the JAX package does
(``:162-175``, ``_InitCtx`` :108-146): equal seeds give equal weights.
"""
from __future__ import annotations

import re
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..core.device import fp32_strict
from ..core.mesh import batches_over_devices, fan_out_devices, replica
from .common import batch_stats

_BN_EPS = 1e-3
_BN_MOMENTUM = 0.01       # Keras's momentum 0.99


class _Build:
    """The graph's ops in build mode: tensors are channel counts, and each
    conv creates its modules (in creation order, with their names)."""

    def __init__(self, net: "InceptionResNetV2"):
        self.net = net
        self.n_auto = 0

    def names(self, name):
        if name is not None:
            return name, name + "_bn"
        i, self.n_auto = self.n_auto, self.n_auto + 1
        return (("conv2d", "batch_normalization") if i == 0
                else (f"conv2d_{i}", f"batch_normalization_{i}"))

    def conv_bn(self, cin, filters, kernel, strides=1, padding="same",
                activation="relu", use_bias=False, name=None):
        kh, kw = (kernel, kernel) if isinstance(kernel, int) else kernel
        cname, bname = self.names(name)
        pad = (kh // 2, kw // 2) if padding == "same" else 0
        self.net.add_module(cname, nn.Conv2d(cin, filters, (kh, kw), strides,
                                             pad, bias=use_bias))
        if not use_bias:
            bn = nn.BatchNorm2d(filters, eps=_BN_EPS, momentum=_BN_MOMENTUM)
            bn.weight.requires_grad_(False)          # Keras scale=False
            self.net.add_module(bname, bn)
        return filters

    @staticmethod
    def cat(xs):
        return sum(xs)

    @staticmethod
    def max_pool(x):
        return x

    avg_pool = max_pool

    @staticmethod
    def residual(x, up, scale, activation):
        return x


class _Apply(_Build):
    """The graph's ops on tensors, with the modules built by ``_Build``."""

    def conv_bn(self, x, filters, kernel, strides=1, padding="same",
                activation="relu", use_bias=False, name=None):
        cname, bname = self.names(name)
        m = self.net._modules
        x = m[cname](x)
        if not use_bias:
            x = m[bname](x)
        return F.relu(x) if activation == "relu" else x

    @staticmethod
    def cat(xs):
        return torch.cat(xs, dim=1)

    @staticmethod
    def max_pool(x):
        return F.max_pool2d(x, 3, 2)

    @staticmethod
    def avg_pool(x):
        return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)

    @staticmethod
    def residual(x, up, scale, activation):
        x = x + scale * up
        return F.relu(x) if activation == "relu" else x


def _block(ops, x, btype, idx, scale, channels, activation="relu"):
    """One Inception-ResNet block (keras_applications
    ``inception_resnet_block``): branches -> concat -> biased 1x1
    up-projection -> x + scale * up -> ReLU unless ``activation`` is
    None."""
    cb = ops.conv_bn
    if btype == "block35":
        branches = [cb(x, 32, 1), cb(cb(x, 32, 1), 32, 3),
                    cb(cb(cb(x, 32, 1), 48, 3), 64, 3)]
    elif btype == "block17":
        branches = [cb(x, 192, 1),
                    cb(cb(cb(x, 128, 1), 160, (1, 7)), 192, (7, 1))]
    else:
        branches = [cb(x, 192, 1),
                    cb(cb(cb(x, 192, 1), 224, (1, 3)), 256, (3, 1))]
    up = cb(ops.cat(branches), channels, 1, activation=None, use_bias=True,
            name=f"{btype}_{idx}_conv")
    return ops.residual(x, up, scale, activation)


def _graph(ops, x):
    cb = ops.conv_bn
    x = cb(x, 32, 3, strides=2, padding="valid")
    x = cb(x, 32, 3, padding="valid")
    x = cb(x, 64, 3)
    x = ops.max_pool(x)
    x = cb(x, 80, 1, padding="valid")
    x = cb(x, 192, 3, padding="valid")
    x = ops.max_pool(x)
    x = ops.cat([cb(x, 96, 1), cb(cb(x, 48, 1), 64, 5),
                 cb(cb(cb(x, 64, 1), 96, 3), 96, 3),
                 cb(ops.avg_pool(x), 64, 1)])                  # mixed_5b
    for i in range(1, 11):
        x = _block(ops, x, "block35", i, 0.17, 320)
    x = ops.cat([cb(x, 384, 3, strides=2, padding="valid"),
                 cb(cb(cb(x, 256, 1), 256, 3), 384, 3, strides=2,
                    padding="valid"),
                 ops.max_pool(x)])                             # mixed_6a
    for i in range(1, 21):
        x = _block(ops, x, "block17", i, 0.10, 1088)
    x = ops.cat([cb(cb(x, 256, 1), 384, 3, strides=2, padding="valid"),
                 cb(cb(x, 256, 1), 288, 3, strides=2, padding="valid"),
                 cb(cb(cb(x, 256, 1), 288, 3), 320, 3, strides=2,
                    padding="valid"),
                 ops.max_pool(x)])                             # mixed_7a
    for i in range(1, 10):
        x = _block(ops, x, "block8", i, 0.20, 2080)
    x = _block(ops, x, "block8", 10, 1.0, 2080, activation=None)
    return cb(x, 1536, 1, name="conv_7b")


class InceptionResNetV2(nn.Module):
    """keras_applications InceptionResNetV2, include_top=False.

    ``forward`` takes (B, 3, H, W) in [-1, 1] (Keras's 'tf'
    ``preprocess_input``, reference naive_imagenet.py:60), H, W >= 75, and
    returns (B, 1536) features for ``pooling="avg"`` or the (B, 1536, H',
    W') map for ``pooling=None``. ``seed`` draws the initial weights
    (``init``); None leaves torch's own."""

    def __init__(self, pooling: Optional[str] = "avg",
                 seed: Optional[int] = 0):
        super().__init__()
        if pooling not in ("avg", None):
            raise ValueError(f"pooling must be 'avg' or None, not "
                             f"{pooling!r}")
        self.pooling = pooling
        _graph(_Build(self), 3)
        if seed is not None:
            self.init(seed)
        self.eval()

    @torch.no_grad()
    def init(self, seed: int) -> None:
        """Glorot-uniform kernels from ``np.random.RandomState(seed)`` in
        creation order (the Keras default initialiser, drawn as the JAX
        package draws it), zero biases, batch norm at the identity."""
        rng = np.random.RandomState(seed % (2 ** 32))
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                o, i, kh, kw = m.weight.shape
                limit = np.sqrt(6.0 / (kh * kw * i + kh * kw * o))
                w = rng.uniform(-limit, limit, (kh, kw, i, o))
                m.weight.copy_(torch.from_numpy(
                    w.astype(np.float32).transpose(3, 2, 0, 1)))
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = _graph(_Apply(self), x)
        return torch.mean(h, dim=(2, 3)) if self.pooling == "avg" else h

    def apply(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """Features, with batch norm on the running statistics unless
        ``train``."""
        with batch_stats(self, train):
            return self(x)

    def _features(self, x: torch.Tensor) -> torch.Tensor:
        with torch.no_grad(), fp32_strict():
            return self.apply(x)

    def encode_batched(self, dataset: np.ndarray, out: str = "h",
                       batch_size: int = 128, devices=None) -> np.ndarray:
        """(N, 3, H, W) host images -> (N, 1536) pooled features on the
        host, ``batch_size`` at a time on the model's device, in fp32 with
        no TF32 (the drop-in of ``EncodeProject.encode_batched`` for
        ``analysis.imagenet_baseline.extract_features``). The last batch is
        not padded: each row's features are its own.

        With several ``devices`` (default: this process's cards when the
        model is on the card) each batch fans out over them
        (``core.mesh.batches_over_devices``;
        dynamorph_tpu/models/inception_resnet_v2.py:256-275)."""
        if out != "h":
            raise ValueError("InceptionResNetV2 only extracts pooled "
                             "features (out='h')")
        if self.pooling != "avg":
            raise ValueError("encode_batched needs pooling='avg'")
        devices = fan_out_devices(devices, next(self.parameters()).device)
        if len(devices) > 1:
            return batches_over_devices(lambda m, x: m._features(x), self,
                                        dataset, batch_size, devices)
        model = replica(self, devices[0])
        outs = []
        for i in range(0, len(dataset), batch_size):
            x = torch.from_numpy(np.asarray(
                dataset[i: i + batch_size], dtype=np.float32)).to(devices[0])
            outs.append(model._features(x).cpu())
        return torch.cat(outs).numpy()


# -- Keras .h5 weight import ------------------------------------------------

_AUTO_RE = re.compile(r"(conv2d|batch_normalization)(?:_(\d+))?$")
# weighted layers a with-top keras file carries beyond the notop graph
_TOP_ONLY = {"predictions"}


def _canonical_auto_names(layers: Dict[str, dict]) -> Dict[str, str]:
    """A weight file's auto-numbered conv and batch-norm names -> the
    fresh-session numbering of this module. Keras numbers auto-names in
    creation order with a session-wide counter, so a file saved after other
    models were built starts at an offset (``conv2d_244``, ...); sorting by
    suffix restores the positions."""
    out = {}
    for prefix in ("conv2d", "batch_normalization"):
        names = []
        for n in layers:
            m = _AUTO_RE.fullmatch(n)
            if m and m.group(1) == prefix:
                names.append((int(m.group(2)) if m.group(2) else -1, n))
        names.sort()
        for i, (_, n) in enumerate(names):
            out[n] = prefix if i == 0 else f"{prefix}_{i}"
    return out


def import_keras_inception_resnet_v2(path: str, pooling: Optional[str] =
                                     "avg") -> InceptionResNetV2:
    """keras_applications InceptionResNetV2 weights (the legacy ``.h5``
    layout of the distributed files, or an ``.npz`` of
    ``<layer>/<weight>:0`` keys) as a model on the CPU. Every layer must be
    in the file with matching shapes; a with-top file's ``predictions``
    layer is ignored and any other extra weighted layer refused."""
    from ..seg.keras_import import (keras_state_dict,
                                    read_keras_layer_weights)

    net = InceptionResNetV2(pooling=pooling, seed=None)
    raw = read_keras_layer_weights(path)
    rename = _canonical_auto_names(raw)
    layers = {rename.get(k, k): v for k, v in raw.items()}
    sd, seen = keras_state_dict(
        net, layers, f"{path} is missing layer '{{layer}}' — not an "
        "InceptionResNetV2 weight file?")
    extra = {n for n, w in layers.items() if w} - seen - _TOP_ONLY
    if extra:
        raise ValueError(f"{path} has unexpected weighted layers "
                         f"{sorted(extra)[:5]} — not an InceptionResNetV2 "
                         "notop weight file")
    net.load_state_dict(sd, strict=True)
    return net
