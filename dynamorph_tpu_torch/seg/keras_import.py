"""Import reference-trained Keras U-Net weights (``.h5``) into
``models.unet_keras``: the port of ``dynamorph_tpu/seg/keras_import.py``.

The reference saves segmentation models with ``model.save_weights(path)``
(NNsegmentation/models.py:195-197), Keras HDF5, read here by the port's
own reader (``io/hdf5.py``). Accepted inputs:

- ``.h5``/``.hdf5`` from ``model.save_weights`` (layer groups at the root)
  or from ``model.save`` (layer groups under ``model_weights``);
- ``.npz`` from ``tools/export_keras_unet.py`` (keys
  ``<layer>/<weight>:0``).

The sm.Unet is one layer of the outer Keras model, so its weights sit at
``<model name>/<layer>/<weight>:0`` under a session-dependent model name;
keying on the last two path components, unique across the graph, flattens
it. Conv kernels are Keras's (kh, kw, in, out) and become torch's (out, in,
kh, kw); batch norm's ``gamma``/``beta``/``moving_mean``/
``moving_variance`` become ``weight``/``bias``/``running_mean``/
``running_var``. ``bn_data`` has no gamma in the file (``scale=False``):
its weight is 1.

The importers return a state_dict of ``KerasUNet`` (or
``MultiSliceKerasUNet``) names on the CPU, which ``load_state_dict(...,
strict=True)`` takes.
"""
from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np
import torch

from ..core.device import fp32_strict
from ..io import hdf5
from ..models.unet_keras import KerasUNet, MultiSliceKerasUNet

_KERAS_SUFFIXES = (".h5", ".hdf5")


def is_keras_weight_file(path: str) -> bool:
    return os.path.splitext(path)[1].lower() in _KERAS_SUFFIXES


def read_keras_layer_weights(path: str) -> Dict[str, Dict[str, np.ndarray]]:
    """A Keras HDF5 weight file (or exporter ``.npz``) as ``{layer:
    {weight: array}}``, the ``:0`` suffixes stripped."""
    layers: Dict[str, Dict[str, np.ndarray]] = {}

    def add(full_name: str, arr: np.ndarray) -> None:
        parts = full_name.split("/")
        if len(parts) < 2:
            return
        layer, wname = parts[-2], parts[-1].split(":")[0]
        layers.setdefault(layer, {})[wname] = np.asarray(arr)

    if path.endswith(".npz"):
        with np.load(path) as f:
            for k in f.files:
                add(k, f[k])
        return layers
    with hdf5.File(path) as f:
        root = "model_weights" if "model_weights" in f.keys() else ""
        for name, arr in f.walk(root):
            add(name, arr)
    return layers


def is_multislice_weight_file(path: str, layers=None) -> bool:
    """True when the file carries the 2.5-D ``SegmentWithMultipleSlice``
    head layers (reference NNsegmentation/models.py:252-253)."""
    if layers is None:
        layers = read_keras_layer_weights(path)
    return "post_conv" in layers and "pred_head" in layers


def keras_state_dict(net: torch.nn.Module, layers, missing: str,
                     shape_hint: str = ""
                     ) -> Tuple[Dict[str, torch.Tensor], set]:
    """The state_dict of ``net`` (whose children carry Keras layer names:
    convolutions and batch norms; built on the meta device or not) filled
    from parsed Keras ``layers``, and the set of layer names it used.
    Every layer of the net must be in ``layers`` with matching shapes
    (``missing`` is the error of an absent one, formatted with ``layer``;
    ``shape_hint`` ends the error of a shape mismatch). A batch norm reads
    its gamma where the layer trains one; a fixed gamma (Keras
    ``scale=False``) is 1."""
    seen: set = set()

    def take(layer: str, wname: str, expect_shape) -> torch.Tensor:
        if layer not in layers:
            raise ValueError(missing.format(layer=layer))
        if wname not in layers[layer]:
            raise ValueError(f"layer '{layer}' has no weight '{wname}' "
                             f"(found {sorted(layers[layer])})")
        arr = layers[layer][wname].astype(np.float32)
        if tuple(arr.shape) != tuple(expect_shape):
            raise ValueError(
                f"shape mismatch for {layer}/{wname}: file has {arr.shape}, "
                f"model expects {tuple(expect_shape)}{shape_hint}")
        seen.add(layer)
        return torch.from_numpy(np.ascontiguousarray(arr))

    sd: Dict[str, torch.Tensor] = {}
    for name, mod in net.named_children():
        if isinstance(mod, torch.nn.Conv2d):
            o, i, kh, kw = mod.weight.shape
            sd[name + ".weight"] = take(name, "kernel", (kh, kw, i, o)) \
                .permute(3, 2, 0, 1).contiguous()
            if mod.bias is not None:
                sd[name + ".bias"] = take(name, "bias", (o,))
        else:                                           # batch norm
            n = mod.num_features
            sd[name + ".weight"] = take(name, "gamma", (n,)) \
                if mod.weight.requires_grad else torch.ones(n)
            sd[name + ".bias"] = take(name, "beta", (n,))
            sd[name + ".running_mean"] = take(name, "moving_mean", (n,))
            sd[name + ".running_var"] = take(name, "moving_variance", (n,))
            sd[name + ".num_batches_tracked"] = torch.tensor(0)
    return sd, seen


def _unet_state_dict(net, layers, path: str, kind: str):
    return keras_state_dict(
        net, layers, f"keras weight file {path} is missing layer '{{layer}}'"
        f" — not a {kind} checkpoint?",
        " — check n_channels/n_classes/decoder_filters")


def import_keras_unet(path: str, n_channels: int = 2, n_classes: int = 3,
                      decoder_filters=(256, 128, 64, 32, 16)
                      ) -> Dict[str, torch.Tensor]:
    """A reference ``.h5`` (or exporter ``.npz``) as a ``KerasUNet``
    state_dict. Every layer must be present with matching shapes, and an
    extra weighted layer is refused, so a 2.5-D checkpoint cannot load as
    a 2-D model (``import_keras_unet_multislice`` takes those)."""
    with torch.device("meta"):
        net = KerasUNet(n_channels, n_classes, decoder_filters)
    layers = read_keras_layer_weights(path)
    sd, seen = _unet_state_dict(net, layers, path, "2-D Segment")
    extra = {k for k, w in layers.items() if w} - seen
    if extra:
        hint = (" — this looks like a 2.5-D SegmentWithMultipleSlice "
                "checkpoint; use import_keras_unet_multislice / "
                "SegmentWithMultipleSlice.load"
                if {"post_conv", "pred_head"} <= extra else
                " — a plain 2-D Segment checkpoint has none")
        raise ValueError(
            f"keras weight file {path} has unexpected weighted layers "
            f"{sorted(extra)}{hint}")
    return sd


def multislice_dims_from_file(path: str, layers=None
                              ) -> Tuple[int, int, int, int]:
    """(n_channels, n_slices, unet_feat, n_classes) of a 2.5-D checkpoint,
    from its own kernels: pre_conv's in-channels, post_conv's in-channels
    (the merge folds Z * unet_feat into channels, reference
    layers.py:51-86), final_conv's and pred_head's out-channels."""
    if layers is None:
        layers = read_keras_layer_weights(path)
    for need in ("pre_conv", "post_conv", "pred_head", "final_conv"):
        if need not in layers or "kernel" not in layers[need]:
            raise ValueError(f"{path}: missing layer '{need}' — not a "
                             "SegmentWithMultipleSlice checkpoint")
    n_channels = int(layers["pre_conv"]["kernel"].shape[2])
    unet_feat = int(layers["final_conv"]["kernel"].shape[3])
    merged_in = int(layers["post_conv"]["kernel"].shape[2])
    if merged_in % unet_feat:
        raise ValueError(
            f"{path}: post_conv in-channels {merged_in} is not a multiple "
            f"of the U-Net feature width {unet_feat}")
    n_classes = int(layers["pred_head"]["kernel"].shape[3])
    return n_channels, merged_in // unet_feat, unet_feat, n_classes


def import_keras_unet_multislice(path: str, n_channels: int = None,
                                 n_slices: int = None, unet_feat: int = None,
                                 n_classes: int = None,
                                 decoder_filters=(256, 128, 64, 32, 16),
                                 layers=None) -> Dict[str, torch.Tensor]:
    """A reference 2.5-D ``SegmentWithMultipleSlice`` ``.h5`` (reference
    NNsegmentation/models.py:206-258) as a ``MultiSliceKerasUNet``
    state_dict: the shared body (classes = unet_feat) and the ``post_conv``
    / ``pred_head`` 1x1 heads. The dimensions default to those the file
    encodes (``multislice_dims_from_file``) and must equal them."""
    if layers is None:
        layers = read_keras_layer_weights(path)
    dims = multislice_dims_from_file(path, layers=layers)
    asked = tuple(d if a is None else a for a, d in zip(
        (n_channels, n_slices, unet_feat, n_classes), dims))
    if dims != asked:
        raise ValueError(
            f"{path} encodes (n_channels, n_slices, unet_feat, n_classes)="
            f"{dims} but the caller requested {asked}")
    with torch.device("meta"):
        net = MultiSliceKerasUNet(dims[0], dims[1], dims[3], dims[2],
                                  decoder_filters)
    sd, seen = _unet_state_dict(net, layers, path,
                                "SegmentWithMultipleSlice")
    extra = {k for k, w in layers.items() if w} - seen
    if extra:
        raise ValueError(
            f"keras weight file {path} has unexpected weighted layers "
            f"{sorted(extra)} beyond the 2.5-D graph")
    return sd


def verify_against_golden(net: KerasUNet, golden_path: str,
                          atol: float = 2e-3,
                          min_class_agreement: float = 0.999) -> float:
    """Hold an imported model (on its device) against the golden
    activations of ``tools/export_keras_unet.py`` (``golden_input`` /
    ``golden_logits`` in the ``.npz``), in fp32 with no TF32. Returns the
    largest absolute logit deviation; raises if it is over ``atol`` or if
    the predicted classes agree on fewer than ``min_class_agreement`` of
    the pixels (a scalar tolerance alone misses class flips where the top
    two logits sit within ``atol`` of each other)."""
    with np.load(golden_path) as f:
        if "golden_input" not in f or "golden_logits" not in f:
            raise ValueError(f"{golden_path} has no golden activations — "
                             "re-run tools/export_keras_unet.py")
        x = f["golden_input"].astype(np.float32)
        want = f["golden_logits"].astype(np.float32)
    dev = next(net.parameters()).device
    with torch.no_grad(), fp32_strict():
        got = net.apply(torch.from_numpy(x).to(dev), train=False) \
            .cpu().numpy()
    worst = float(np.max(np.abs(got - want)))
    if worst > atol:
        raise AssertionError(
            f"imported model deviates from TF goldens by {worst:.3e} "
            f"(atol {atol:.1e})")
    agreement = float(np.mean(got.argmax(axis=1) == want.argmax(axis=1)))
    if agreement < min_class_agreement:
        raise AssertionError(
            f"imported model's predicted classes agree with the TF goldens "
            f"on only {agreement:.4%} of pixels "
            f"(min {min_class_agreement:.4%}) — class-flipping import bug")
    return worst
