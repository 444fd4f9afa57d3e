"""Weight bridge into the port: JAX-package parameters and reference
``model.pt`` files to the port's ``state_dict``.

``state_dict_from_jax`` takes the JAX package's ``(params, state)`` as
nested dicts of **numpy** arrays (``jax.device_get`` of them) and names them
as the reference does — the mapping of
``dynamorph_tpu/models/torch_export.py:48-94`` for the VQ-VAEs, the name
maps of ``dynamorph_tpu/models/torch_import.py`` read the other way for the
VAE family (:118-185) and the ResNet encoders (:202-272), the
``segmentation_models_pytorch`` layout of ``models/unet.py`` for the U-Net,
and the Keras layer names of ``models/unet_keras.py`` and
``models/inception_resnet_v2.py``, whose JAX trees are flat dicts keyed by
those names. It needs no jax.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..nn.functional import (conv_kernel_to_torch,
                             conv_transpose_kernel_to_torch)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))   # a writable, contiguous copy


def _conv(out: Dict, prefix: str, p) -> None:
    out[prefix + ".weight"] = _t(conv_kernel_to_torch(p["kernel"]))
    if "bias" in p:
        out[prefix + ".bias"] = _t(p["bias"])


def _deconv(out: Dict, prefix: str, p) -> None:
    out[prefix + ".weight"] = _t(conv_transpose_kernel_to_torch(p["kernel"]))
    out[prefix + ".bias"] = _t(p["bias"])


def _bn(out: Dict, prefix: str, p, s) -> None:
    out[prefix + ".weight"] = _t(p["scale"])
    out[prefix + ".bias"] = _t(p["offset"])
    out[prefix + ".running_mean"] = _t(s["mean"])
    out[prefix + ".running_var"] = _t(s["var"])
    out[prefix + ".num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)


def _linear(out: Dict, prefix: str, p) -> None:
    out[prefix + ".weight"] = _t(np.transpose(np.asarray(p["weight"])))
    if "bias" in p:
        out[prefix + ".bias"] = _t(p["bias"])


def _residual_stack(out: Dict, prefix: str, params, state) -> None:
    for i, (p, s) in enumerate(zip(params, state)):
        b = f"{prefix}.layers.{i}"
        _conv(out, f"{b}.1", p["conv1"])
        _bn(out, f"{b}.2", p["bn1"], s["bn1"])
        _conv(out, f"{b}.4", p["conv2"])
        _bn(out, f"{b}.5", p["bn2"], s["bn2"])


def _resnet_trunk(out: Dict, prefix: str, params, state) -> None:
    """A stem + layer1..4 trunk (basic or bottleneck blocks) under
    torchvision's names below ``prefix``."""
    _conv(out, f"{prefix}conv1", params["stem"]["conv"])
    _bn(out, f"{prefix}bn1", params["stem"]["bn"], state["stem"]["bn"])
    for li in range(1, 5):
        for b, (p, s) in enumerate(zip(params[f"layer{li}"],
                                       state[f"layer{li}"])):
            pre = f"{prefix}layer{li}.{b}"
            for k in ("1", "2", "3"):
                if f"conv{k}" in p:
                    _conv(out, f"{pre}.conv{k}", p[f"conv{k}"])
                    _bn(out, f"{pre}.bn{k}", p[f"bn{k}"], s[f"bn{k}"])
            if "down" in p:
                _conv(out, f"{pre}.downsample.0", p["down"])
                _bn(out, f"{pre}.downsample.1", p["down_bn"], s["down_bn"])


def _encode_project(params, state) -> Dict[str, torch.Tensor]:
    """``EncodeProject`` -> ``models/resnet_simclr.py`` names
    (``import_encode_project``, torch_import.py:248-272, read backwards).
    The head's last batch norm has no offset in the JAX package; its
    frozen ``bias`` is 0."""
    out: Dict[str, torch.Tensor] = {}
    _resnet_trunk(out, "convnet.", params, state)
    p, s = params["proj"], state["proj"]
    _linear(out, "projection.fc1", p["fc1"])
    _bn(out, "projection.bn1", p["bn1"], s["bn1"])
    _linear(out, "projection.fc2", p["fc2"])
    scale = np.asarray(p["bn2"]["scale"])
    _bn(out, "projection.bn2",
        {"scale": scale, "offset": np.zeros_like(scale)}, s["bn2"])
    return out


def _z16_trunk(out: Dict, e, es, d) -> None:
    """The z16 encoder (``enc.0`` ... ``enc.12``, and the VAE's ``enc.13``
    where the JAX tree has ``conv5``) and decoder (``dec.*``), shared by
    VQ_VAE_z16, VAE, IWAE and AAE (torch_import.py:118-150)."""
    _conv(out, "enc.0", e["conv0"])
    _conv(out, "enc.1", e["conv1"])
    _bn(out, "enc.2", e["bn1"], es["bn1"])
    _conv(out, "enc.4", e["conv2"])
    _bn(out, "enc.5", e["bn2"], es["bn2"])
    _conv(out, "enc.7", e["conv3"])
    _bn(out, "enc.8", e["bn3"], es["bn3"])
    _conv(out, "enc.10", e["conv4"])
    _bn(out, "enc.11", e["bn4"], es["bn4"])
    _residual_stack(out, "enc.12", e["res"], es["res"])
    if "conv5" in e:
        _conv(out, "enc.13", e["conv5"])
    _deconv(out, "dec.0", d["deconv0"])
    _deconv(out, "dec.2", d["deconv1"])
    _deconv(out, "dec.4", d["deconv2"])
    _conv(out, "dec.6", d["conv_out"])


def _discriminator(out: Dict, p, s) -> None:
    """The AAE's ``enc_d`` (``import_aae``, torch_import.py:162-185)."""
    _conv(out, "enc_d.0", p["conv0"])
    _conv(out, "enc_d.1", p["conv1"])
    _bn(out, "enc_d.2", p["bn1"], s["bn1"])
    _conv(out, "enc_d.4", p["conv2"])
    _bn(out, "enc_d.5", p["bn2"], s["bn2"])
    _conv(out, "enc_d.7", p["conv3"])
    _bn(out, "enc_d.8", p["bn3"], s["bn3"])
    _linear(out, "enc_d.11", p["fc1"])
    _linear(out, "enc_d.14", p["fc2"])
    _linear(out, "enc_d.17", p["fc3"])


def _unet(params, state) -> Dict[str, torch.Tensor]:
    """``dynamorph_tpu/models/unet.py`` -> ``models/unet.py`` names; with
    the 1x1 heads of ``SegmentWithMultipleSlice`` (``post_conv``,
    ``pred_head``) where the params hold them (``MultiSliceUNet``)."""
    out: Dict[str, torch.Tensor] = {}
    _conv(out, "pre_conv", params["pre_conv"])
    _resnet_trunk(out, "encoder.", params, state)
    for i, (p, s) in enumerate(zip(params["decoder"], state["decoder"])):
        for k in ("1", "2"):
            _conv(out, f"decoder.blocks.{i}.conv{k}.0", p[f"conv{k}"])
            _bn(out, f"decoder.blocks.{i}.conv{k}.1", p[f"bn{k}"],
                s[f"bn{k}"])
    _conv(out, "segmentation_head.0", params["head"])
    for head in ("post_conv", "pred_head"):
        if head in params:
            _conv(out, head, params[head])
    return out


def _keras_layers(params, state) -> Dict[str, torch.Tensor]:
    """A flat ``{Keras layer: conv or batch-norm params}`` tree (the JAX
    ``KerasUNet``, its multi-slice heads included, and
    ``InceptionResNetV2``) -> the same names with torch's suffixes."""
    out: Dict[str, torch.Tensor] = {}
    for name, p in params.items():
        if "kernel" in p:
            _conv(out, name, p)
        else:
            _bn(out, name, p, state[name])
    return out


def state_dict_from_jax(params, state, network: str,
                        channel_var=(1.0, 1.0)) -> Dict[str, torch.Tensor]:
    """JAX ``(params, state)`` (numpy leaves) -> the port's ``state_dict``
    for ``network`` ("VQ_VAE_z16", "VQ_VAE_z32", "VAE", "IWAE", "AAE",
    "ResNet18/50/101/152", "UNet", "KerasUNet" or "InceptionResNetV2";
    ``channel_var`` is the buffer of the VQ-VAEs and the VAE family)."""
    if network == "UNet":
        return _unet(params, state)
    if network in ("KerasUNet", "InceptionResNetV2"):
        return _keras_layers(params, state)
    if network.startswith("ResNet"):
        return _encode_project(params, state)
    out: Dict[str, torch.Tensor] = {}
    e, es = params["enc"], state["enc"]
    if network in ("VQ_VAE_z16", "VAE", "IWAE", "AAE"):
        _z16_trunk(out, e, es, params["dec"])
        if network == "AAE":
            _discriminator(out, params["enc_d"], state["enc_d"])
        n_inputs = out["enc.0.weight"].shape[1]
    elif network == "VQ_VAE_z32":
        _conv(out, "enc.0", e["conv1"])
        _bn(out, "enc.1", e["bn1"], es["bn1"])
        _conv(out, "enc.3", e["conv2"])
        _bn(out, "enc.4", e["bn2"], es["bn2"])
        _residual_stack(out, "enc.5", e["res"], es["res"])
        d, ds = params["dec"], state["dec"]
        _residual_stack(out, "dec.0", d["res"], ds["res"])
        _deconv(out, "dec.1", d["deconv0"])
        _bn(out, "dec.2", d["bn"], ds["bn"])
        _deconv(out, "dec.4", d["deconv1"])
        n_inputs = out["dec.4.weight"].shape[1]
    else:
        raise ValueError(f"no JAX weight bridge for network {network!r}")
    if "vq" in params:
        out["vq.w.weight"] = _t(params["vq"]["codebook"])
    out["channel_var"] = torch.as_tensor(
        np.asarray(channel_var, np.float32).reshape(1, n_inputs, 1, 1))
    return out


def load_reference_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A reference ``model.pt`` (a saved ``state_dict``) as a dict of CPU
    tensors. ``weights_only`` loading runs no pickled code."""
    return dict(torch.load(path, map_location="cpu", weights_only=True))
