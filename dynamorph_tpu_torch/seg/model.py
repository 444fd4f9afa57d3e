"""Segment: the U-Net segmentation model wrapper (fit / predict / save /
load), and the 2.5-D ``SegmentWithMultipleSlice`` — the port of
``dynamorph_tpu/seg/model.py`` (reference NNsegmentation/models.py:32-258).

Weights are a ``model.pt`` state_dict, as a file or inside a directory, or
a reference-trained Keras ``.h5``/``.hdf5`` (``seg/keras_import.py``). Two
architectures serve: ``models/unet.py`` (a new model, and the JAX
package's own U-Net, bridged with
``models.jax_import.state_dict_from_jax(params, state, "UNet")``) and the
Keras graph of ``models/unet_keras.py``, to which ``load`` switches for a
Keras file or for a ``model.pt`` of its names (``bn_data.*``).

Training (``fit``, reference models.py:98-156) is the JAX package's: Adam
at 1e-3 on the weighted cross-entropy of the logits, the epoch order from
``np.random.RandomState(seed)``, TerminateOnNaN once an epoch,
ReduceLROnPlateau(patience=5, min_lr=1e-7) lowering the rate in place
(Adam's moments kept), a ``weights.<epoch>-<val_loss>/model.pt`` checkpoint
per validated epoch written on an ``io.prefetch.AsyncWriter`` thread, and
the validation's summed cross-entropy, ROC-AUC and F1 on the raw class-0
logits (``seg/metrics.py``, on the device). The dataset stays on the device
across epochs when it fits. The step runs forward, backward and Adam inside
``fp32_strict``. With the Keras graph, ``bn_data``'s fixed gamma is no
parameter of the optimizer, and ``freeze_encoder`` zeroes the gradients of
its encoder's layers (``encoder_layer_names``), as the JAX step does.
"""
from __future__ import annotations

import os
import tempfile
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from ..core.constants import CHANNEL_MAX
from ..core.device import fp32_strict, resolve_device
from ..io.prefetch import AsyncWriter
from ..models.common import load_torchvision_weights
from ..models.jax_import import load_reference_checkpoint
from ..models.unet import MultiSliceUNet, UNet, weighted_ce_loss
from ..models.unet_keras import KerasUNet, MultiSliceKerasUNet
from . import keras_import
from .data import preprocess
from .metrics import f1_score, roc_auc_score


class Segment:
    """U-Net semantic segmentation model (reference NNsegmentation/models.py:32).

    Args:
        input_shape: (c, x, y), the reference's channels-first input spec.
        n_classes: number of prediction classes.
        freeze_encoder: train with the encoder's gradients zeroed (its
            batch norm statistics still move, as in the JAX package).
        model_path: directory of the per-epoch checkpoints (a new temporary
            one if omitted).
        seed: seed of the random initial weights.
        encoder_weights: a torchvision-format resnet34 state_dict (a dict
            of tensors or arrays, or a path to one) for the encoder (the
            reference's ``Unet('resnet34', encoder_weights='imagenet')``);
            ``fc.*`` and other keys outside the encoder are ignored, and
            every encoder weight must be in it.
        device: where the network runs ("cuda" unless the caller asks for
            the CPU; without a card "cuda" raises).
    """

    def __init__(self, input_shape=(2, 256, 256), n_classes: int = 3,
                 freeze_encoder: bool = False,
                 model_path: Optional[str] = None, seed: int = 0,
                 encoder_weights=None,
                 device: Union[str, torch.device] = "cuda"):
        self.input_shape = tuple(input_shape)
        self.n_channels = self.input_shape[0]
        self.x_size, self.y_size = self.input_shape[-2:]
        self.n_classes = n_classes
        self.freeze_encoder = freeze_encoder
        self.model_path = model_path
        self.device = resolve_device(device)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.net = self._build_net()
        if encoder_weights is not None:
            self._load_encoder_weights(encoder_weights)
        self.net.to(self.device)
        self._lr = 1e-3  # keras Adam default

    def _build_net(self, keras: bool = False):
        """The torchvision-layout U-Net, or the Keras graph."""
        cls = KerasUNet if keras else UNet
        return cls(n_channels=self.n_channels, n_classes=self.n_classes)

    def _load_encoder_weights(self, encoder_weights) -> None:
        load_torchvision_weights(self.net.encoder, encoder_weights,
                                 "encoder_weights", "resnet34 encoder")

    # -- inference -----------------------------------------------------
    def probabilities(self, x: torch.Tensor) -> torch.Tensor:
        """(B,) + input_shape float32 on the model's device, in [0, 1] ->
        (B, n_classes, 1, x, y) softmax probabilities, full fp32."""
        with torch.no_grad(), fp32_strict():
            return torch.softmax(self.net.apply(x, train=False),
                                 dim=1)[:, :, None]

    def predict_raw(self, x: np.ndarray) -> np.ndarray:
        """Raw intensities (B,) + input_shape -> probabilities as numpy.
        ``x`` uploads in its own dtype (uint16 at half the bytes of
        float32); the cast to float32 and the divide by CHANNEL_MAX run on
        the device, as ``_scaled_predict_fn`` does
        (dynamorph_tpu/seg/inference.py:68-89)."""
        t = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
        return self.probabilities(t.to(torch.float32) / CHANNEL_MAX) \
            .cpu().numpy()

    def predict(self, patches, label_input: str = "prob") -> np.ndarray:
        """(B, n_classes, 1, x, y) softmax probabilities
        (reference models.py:159-182). A list of patch pairs is scaled by
        ``preprocess``; an array goes in as it is."""
        if isinstance(patches, list):
            X, _ = preprocess(patches, label_input=label_input)
            X = X.reshape((-1,) + self.input_shape)
        elif isinstance(patches, np.ndarray):
            X = patches.reshape((-1,) + self.input_shape)
        else:
            raise ValueError("Input format not supported")
        x = torch.from_numpy(X.astype(np.float32)).to(self.device)
        y = self.probabilities(x).cpu().numpy()
        assert y.shape[1:] == (self.n_classes, 1, self.x_size, self.y_size)
        return y

    # -- training ------------------------------------------------------
    def _arrays(self, patches, label_input, class_weights=None):
        X, y = preprocess(patches, n_classes=self.n_classes,
                          label_input=label_input,
                          class_weights=class_weights)
        X = X.reshape((-1,) + self.input_shape).astype(np.float32)
        y = y.reshape((-1, self.n_classes + 1, self.x_size,
                       self.y_size)).astype(np.float32)
        return X, y

    def _make_step(self, lr: float):
        """Adam (0.9, 0.999, eps 1e-8: ``optax.adam``'s update) and the
        train step ``step(x, y) -> loss`` (a device scalar)."""
        params = [p for p in self.net.parameters() if p.requires_grad]
        optimizer = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999),
                                     eps=1e-8)
        encoder = [p for p in self.net.encoder_parameters()
                   if p.requires_grad] if self.freeze_encoder else []

        def step(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
            optimizer.zero_grad(set_to_none=False)
            with fp32_strict():
                loss = weighted_ce_loss(self.net.apply(x, train=True), y)
                loss.backward()
                for p in encoder:
                    p.grad.zero_()
                optimizer.step()
            return loss.detach()

        return optimizer, step

    def fit(self, patches, label_input: str = "prob", batch_size: int = 8,
            n_epochs: int = 10, valid_patches=None,
            valid_label_input: str = "prob", class_weights=None,
            seed: int = 0) -> List[dict]:
        """Train on input-label pairs (reference models.py:98-156).
        Returns one record a finished epoch: ``epoch``, ``loss`` and, with
        ``valid_patches``, ``val_loss``, ``val_roc_auc``, ``val_f1``."""
        if self.model_path is None:
            self.model_path = tempfile.mkdtemp()
        os.makedirs(self.model_path, exist_ok=True)
        X, y = self._arrays(patches, label_input, class_weights)
        valid = None
        if valid_patches is not None:
            valid = self._arrays(valid_patches, valid_label_input)

        optimizer, step = self._make_step(self._lr)
        lr_scale = 1.0
        best_val, plateau = np.inf, 0
        history: List[dict] = []
        rng = np.random.RandomState(seed)
        n = X.shape[0]
        # the sets stay on the device for the whole fit (a 2 x 256 x 256
        # patch and its label take 1.5 MB); a batch is a gather by this
        # epoch's order
        dev = self.device
        X_src = torch.from_numpy(X).to(dev)
        y_src = torch.from_numpy(y).to(dev)
        if valid is not None:
            valid = tuple(torch.from_numpy(a).to(dev) for a in valid)
        with AsyncWriter(depth=1) as saver:
            for epoch in range(n_epochs):
                order = rng.permutation(n)
                loss_sum, n_b = None, 0
                for i in range(0, n, batch_size):
                    bids = order[i: i + batch_size]
                    idx = torch.from_numpy(bids).to(dev)
                    xb, yb = X_src[idx], y_src[idx]
                    loss = step(xb, yb)
                    loss_sum = loss if loss_sum is None else loss_sum + loss
                    n_b += 1
                epoch_loss = float(loss_sum) / n_b
                if not np.isfinite(epoch_loss):  # TerminateOnNaN
                    print("NaN loss encountered, terminating training")
                    return history
                rec = {"epoch": epoch, "loss": epoch_loss}
                if valid is not None:
                    rec.update(self._validate(valid))
                    # ReduceLROnPlateau(patience=5, min_lr=1e-7)
                    if rec["val_loss"] < best_val - 1e-12:
                        best_val, plateau = rec["val_loss"], 0
                    else:
                        plateau += 1
                        if plateau >= 5 and self._lr * lr_scale > 1e-7:
                            lr_scale *= 0.1
                            for group in optimizer.param_groups:
                                group["lr"] = max(self._lr * lr_scale, 1e-7)
                            plateau = 0
                    snapshot = {k: v.detach().clone()
                                for k, v in self.net.state_dict().items()}
                    saver.submit(_save_state, snapshot, os.path.join(
                        self.model_path, "weights.%02d-%.2f"
                        % (epoch, rec["val_loss"])))
                history.append(rec)
                print(f"epoch {epoch}: " +
                      "  ".join(f"{k}:{v:.4f}" for k, v in rec.items()
                                if k != "epoch"))
        return history

    def _validate(self, valid) -> Dict[str, float]:
        """Summed weighted cross-entropy over the validation set, divided
        by its pixel count, and ROC-AUC / F1 of the raw class-0 logits
        against ``label[:, 0] > 0.5`` (reference layers.py:118-143), 8
        patches a forward."""
        vX, vy = valid
        dev = self.device
        ce_sum, preds = None, []
        with torch.no_grad(), fp32_strict():
            for i in range(0, len(vX), 8):
                xb = torch.as_tensor(vX[i: i + 8], device=dev)
                yb = torch.as_tensor(vy[i: i + 8], device=dev)
                logits = self.net.apply(xb, train=False)
                ce = -torch.sum(yb[:, :-1] * torch.log_softmax(logits, 1),
                                dim=1) * yb[:, -1]
                s = torch.sum(ce)
                ce_sum = s if ce_sum is None else ce_sum + s
                preds.append(logits[:, 0])
        y_pred = torch.cat(preds)
        val_loss = float(ce_sum) / y_pred.numel()
        y_true = torch.as_tensor(vy[:, 0], device=dev) > 0.5
        try:
            roc = roc_auc_score(y_true, y_pred)
            f1 = f1_score(y_true, y_pred > 0.5)
        except ValueError:  # single-class validation set
            roc, f1 = float("nan"), float("nan")
        return {"val_loss": val_loss, "val_roc_auc": float(roc),
                "val_f1": float(f1)}

    # -- weights -------------------------------------------------------
    def save(self, path: str) -> None:
        """Write the state_dict to ``path`` if it ends in ``.pt``, else to
        ``path/model.pt``."""
        _save_state(self.net.state_dict(), path)

    def load(self, path: str) -> None:
        """Load weights (strict): a reference-trained Keras ``.h5`` /
        ``.hdf5`` (NNsegmentation/models.py:200-202), imported weight for
        weight into the Keras graph, or a ``model.pt`` state_dict given as
        the file or a directory that holds it, into the architecture its
        names belong to."""
        if keras_import.is_keras_weight_file(path):
            self._adopt(self._import_keras(path))
            return
        if os.path.isdir(path):
            if not os.path.exists(os.path.join(path, "model.pt")):
                raise ValueError(
                    f"{path} is a directory without a model.pt; orbax "
                    "checkpoint directories need the JAX package: restore "
                    "it there and bridge the (params, state) with "
                    "dynamorph_tpu_torch.models.jax_import."
                    "state_dict_from_jax(params, state, 'UNet')")
            path = os.path.join(path, "model.pt")
        self._adopt(load_reference_checkpoint(path))

    def _import_keras(self, path: str) -> Dict[str, torch.Tensor]:
        return keras_import.import_keras_unet(
            path, n_channels=self.n_channels, n_classes=self.n_classes)

    def _adopt(self, sd: Dict[str, torch.Tensor]) -> None:
        """Load ``sd`` strict, first rebuilding the network where ``sd``
        belongs to the other architecture (the Keras graph's names begin
        ``bn_data.*``) or to other dims (``_take_dims``)."""
        keras = "bn_data.running_mean" in sd
        if self._take_dims(sd) or keras != isinstance(self.net, KerasUNet):
            with torch.random.fork_rng(devices=[]):
                self.net = self._build_net(keras).to(self.device)
        self.net.load_state_dict(sd, strict=True)

    def _take_dims(self, sd: Dict[str, torch.Tensor]) -> bool:
        """Adopt the dims that ``sd`` fixes; True if they changed."""
        return False


def _save_state(state: Dict[str, torch.Tensor], path: str) -> None:
    """``torch.save`` of a state_dict's host copy to ``path`` (a ``.pt``
    file) or ``path/model.pt``."""
    if not path.endswith(".pt"):
        os.makedirs(path, exist_ok=True)
        path = os.path.join(path, "model.pt")
    torch.save({k: v.detach().cpu() for k, v in state.items()}, path)


class SegmentWithMultipleSlice(Segment):
    """2.5-D segmentation: several z or time slices a sample, each through
    the shared U-Net at ``n_classes=unet_feat``, merged by a 1x1 ReLU conv
    and a 1x1 head (``models.unet.MultiSliceUNet``; reference
    NNsegmentation/models.py:206-258).

    ``input_shape`` is 4-D, (c, z, x, y).
    """

    def __init__(self, unet_feat: int = 32, **kwargs):
        self.unet_feat = unet_feat
        super().__init__(**kwargs)
        self.n_slices = self.input_shape[1]

    def _build_net(self, keras: bool = False):
        cls = MultiSliceKerasUNet if keras else MultiSliceUNet
        return cls(n_channels=self.n_channels, n_slices=self.input_shape[1],
                   n_classes=self.n_classes, unet_feat=self.unet_feat)

    def _import_keras(self, path: str) -> Dict[str, torch.Tensor]:
        """A 2.5-D ``.h5`` (reference NNsegmentation/models.py:206-258),
        read once: its dims must be this model's (its ``unet_feat`` is
        taken from the file)."""
        layers = keras_import.read_keras_layer_weights(path)
        fc, fz, ff, fk = keras_import.multislice_dims_from_file(
            path, layers=layers)
        if (fc, fz, fk) != (self.n_channels, self.n_slices, self.n_classes):
            raise ValueError(
                f"{path} encodes (n_channels, n_slices, n_classes)="
                f"{(fc, fz, fk)} but this model was built with "
                f"{(self.n_channels, self.n_slices, self.n_classes)}")
        return keras_import.import_keras_unet_multislice(path, layers=layers)

    def _take_dims(self, sd: Dict[str, torch.Tensor]) -> bool:
        """``unet_feat`` from the weights' ``post_conv``."""
        feat = int(sd["post_conv.weight"].shape[0]) \
            if "post_conv.weight" in sd else self.unet_feat
        changed, self.unet_feat = feat != self.unet_feat, feat
        return changed
