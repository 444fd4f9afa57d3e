"""Weight bridge into the port: JAX-package parameters and reference
``model.pt`` files to the port's ``state_dict``.

``state_dict_from_jax`` takes the JAX package's ``(params, state)`` as
nested dicts of **numpy** arrays (``jax.device_get`` of them) and names them
as the reference does — the mapping of
``dynamorph_tpu/models/torch_export.py:48-94`` for the VQ-VAEs, and the
``segmentation_models_pytorch`` layout of ``models/unet.py`` for the U-Net.
It needs no jax.
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


def _residual_stack(out: Dict, prefix: str, params, state) -> None:
    for i, (p, s) in enumerate(zip(params, state)):
        b = f"{prefix}.layers.{i}"
        _conv(out, f"{b}.1", p["conv1"])
        _bn(out, f"{b}.2", p["bn1"], s["bn1"])
        _conv(out, f"{b}.4", p["conv2"])
        _bn(out, f"{b}.5", p["bn2"], s["bn2"])


def _unet(params, state) -> Dict[str, torch.Tensor]:
    """``dynamorph_tpu/models/unet.py`` -> ``models/unet.py`` names."""
    out: Dict[str, torch.Tensor] = {}
    _conv(out, "pre_conv", params["pre_conv"])
    _conv(out, "encoder.conv1", params["stem"]["conv"])
    _bn(out, "encoder.bn1", params["stem"]["bn"], state["stem"]["bn"])
    for li in range(1, 5):
        for b, (p, s) in enumerate(zip(params[f"layer{li}"],
                                       state[f"layer{li}"])):
            pre = f"encoder.layer{li}.{b}"
            for k in ("1", "2"):
                _conv(out, f"{pre}.conv{k}", p[f"conv{k}"])
                _bn(out, f"{pre}.bn{k}", p[f"bn{k}"], s[f"bn{k}"])
            if "down" in p:
                _conv(out, f"{pre}.downsample.0", p["down"])
                _bn(out, f"{pre}.downsample.1", p["down_bn"], s["down_bn"])
    for i, (p, s) in enumerate(zip(params["decoder"], state["decoder"])):
        for k in ("1", "2"):
            _conv(out, f"decoder.blocks.{i}.conv{k}.0", p[f"conv{k}"])
            _bn(out, f"decoder.blocks.{i}.conv{k}.1", p[f"bn{k}"],
                s[f"bn{k}"])
    _conv(out, "segmentation_head.0", params["head"])
    return out


def state_dict_from_jax(params, state, network: str,
                        channel_var=(1.0, 1.0)) -> Dict[str, torch.Tensor]:
    """JAX ``(params, state)`` (numpy leaves) -> the port's ``state_dict``
    for ``network`` ("VQ_VAE_z16", "VQ_VAE_z32" or "UNet";
    ``channel_var`` is the VQ-VAEs' buffer)."""
    if network == "UNet":
        return _unet(params, state)
    out: Dict[str, torch.Tensor] = {}
    e, es = params["enc"], state["enc"]
    if network == "VQ_VAE_z16":
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
        d = params["dec"]
        _deconv(out, "dec.0", d["deconv0"])
        _deconv(out, "dec.2", d["deconv1"])
        _deconv(out, "dec.4", d["deconv2"])
        _conv(out, "dec.6", d["conv_out"])
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
    out["vq.w.weight"] = _t(params["vq"]["codebook"])
    out["channel_var"] = torch.as_tensor(
        np.asarray(channel_var, np.float32).reshape(1, n_inputs, 1, 1))
    return out


def load_reference_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A reference ``model.pt`` (a saved ``state_dict``) as a dict of CPU
    tensors. ``weights_only`` loading runs no pickled code."""
    return dict(torch.load(path, map_location="cpu", weights_only=True))
