"""Shared model building blocks: the residual stack, the fused stem conv and
the loss terms (the port of ``dynamorph_tpu/models/common.py``).

Activations are NCHW throughout.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F


class ResidualStack(nn.Module):
    """Residual stack (reference HiddenStateExtractor/vae.py:167-212).

    Each layer is ``x = x + layer(x)`` with layer = ReLU -> Conv3x3(nh->nrh)
    -> BN -> ReLU -> Conv1x1(nrh->nh) -> BN, at the reference's Sequential
    indices 0..5, so the state_dict names are ``layers.{i}.{1,2,4,5}.*``.
    """

    def __init__(self, num_hiddens: int, num_residual_hiddens: int,
                 num_residual_layers: int):
        super().__init__()
        self.layers = nn.ModuleList([
            nn.Sequential(
                nn.ReLU(),
                nn.Conv2d(num_hiddens, num_residual_hiddens, 3, 1, 1),
                nn.BatchNorm2d(num_residual_hiddens),
                nn.ReLU(),
                nn.Conv2d(num_residual_hiddens, num_hiddens, 1, 1, 0),
                nn.BatchNorm2d(num_hiddens),
            ) for _ in range(num_residual_layers)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = x + layer(x)
        return x


def fused_preconv_stride_conv(conv0: nn.Conv2d, conv1: nn.Conv2d,
                              x: torch.Tensor) -> torch.Tensor:
    """``conv1(conv0(x))`` for a 1x1 ``conv0`` as ONE convolution, exactly.

    The z16 encoder opens with a 1x1 channel-lift conv followed by a strided
    4x4 conv with no activation between (reference vae.py:274-275). Both are
    linear, so they compose into one conv with kernel
    ``W01[o, i] = sum_c W1[o, c] W0[c, i]``, and the full-resolution lifted
    intermediate is never written.

    conv0's bias does not fold into a constant: conv1 zero-pads AFTER conv0,
    so border positions see fewer bias-carrying taps. The exact correction
    is ``conv(ones, K_b)`` with ``K_b[o] = sum_c W1[o, c] b0[c]``.
    The composed weights are formed in float64 and rounded once to float32.
    """
    w0 = conv0.weight[:, :, 0, 0].double()            # (Cmid, Cin)
    w1 = conv1.weight.double()                         # (Cout, Cmid, k, k)
    w01 = torch.einsum("ockl,ci->oikl", w1, w0).to(x.dtype)
    stride, padding = conv1.stride, conv1.padding
    y = F.conv2d(x, w01, conv1.bias, stride, padding)
    if conv0.bias is not None:
        kb = torch.einsum("ockl,c->okl", w1, conv0.bias.double())
        kb = kb[:, None].to(x.dtype)                   # (Cout, 1, k, k)
        ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                          device=x.device)
        y = y + F.conv2d(ones, kb, None, stride, padding)
    return y


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def masked_recon_loss(decoded, inputs, batch_mask, channel_var,
                      reduction="mean"):
    """Channel-variance-scaled masked MSE (reference vae.py:319, :439).

    NCHW; ``channel_var`` is (1, C, 1, 1)."""
    if batch_mask is None:
        batch_mask = torch.ones_like(inputs)
    err = (decoded * batch_mask - inputs * batch_mask) ** 2 / channel_var
    return torch.mean(err) if reduction == "mean" else torch.sum(err)


def pairwise_sq_dist_mean(z_flat: torch.Tensor) -> torch.Tensor:
    """(B, L) -> (B, B) matrix of mean_l (z_i - z_j)^2, in matmul form:
    (|z_i|^2 + |z_j|^2 - 2 z_i.z_j) / L, clamped at 0. In fp32: the JAX
    package runs it at DEFAULT precision (models/common.py:66-87), which is
    bf16 on a TPU and fp32 on the CPU, where the tests compare the two."""
    l = z_flat.shape[1]
    sq = torch.sum(z_flat * z_flat, dim=1)
    d = sq[:, None] + sq[None, :] - 2.0 * (z_flat @ z_flat.T)
    return torch.clamp(d, min=0.0) / l


def time_matching_loss(z_flat, time_matching_mat, w_a, w_t, w_n, margin):
    """Trajectory time-matching loss (reference vae.py:322-335).

    Relation codes: 2 = adjacent frames of same trajectory (weight w_a),
    1 = same trajectory (w_t), 0 = negative pair (w_n, with hinge margin:
    clamp(sim*w_n + margin, min=0)).

    ``time_matching_mat`` may be the uint8 block that the feed sends (4x
    fewer bytes): it moves to ``z_flat``'s device as it is and is cast to
    float32 there (dynamorph_tpu/train/steps.py:84-85).
    """
    sim = pairwise_sq_dist_mean(z_flat)
    rel = torch.as_tensor(time_matching_mat).to(z_flat.device).to(
        torch.float32)
    w = torch.where(rel == 2, w_a, torch.where(rel == 1, w_t, w_n))
    val = sim * w
    val = torch.where(rel == 0, torch.clamp(val + margin, min=0.0), val)
    return torch.mean(val)


def vq_losses(z, quantized, commitment_cost):
    """Straight-through estimator + commitment losses (reference
    vae.py:58-63). Returns (st_quantized, loss) where loss = q_latent +
    beta * e_latent."""
    e_latent = torch.mean((quantized.detach() - z) ** 2)
    q_latent = torch.mean((quantized - z.detach()) ** 2)
    st = z + (quantized - z).detach()
    return st, q_latent + commitment_cost * e_latent
