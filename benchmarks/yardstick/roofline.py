"""Peaks of the card and the operations and bytes of the work, counted from
shapes. Frozen copies of the port's chip-script arithmetic (its ``bound``,
``vq_bound``, ``indices_bound`` and ``conv_flops``), extended to the whole
training step.

Operations count 2 per multiply-add. The model's count is the published
architecture's: every convolution and transposed convolution forward, its
weight gradient and (but for the first layer, whose input needs none) its
input gradient; the codebook distances; the time-matching Gram product
forward and backward. Batch norm, activations, losses and Adam are
element-wise and left out.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

from reference import vqvae as ref

# NVIDIA H100 SXM data sheet, at the full 700 W power limit: the HBM rate
# and the fp32 rate outside the tensor cores (the port keeps TF32 off).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12


def bound(nbytes: float, flops: float) -> Tuple[float, str]:
    """(seconds, what bounds it): the larger of the bytes over the HBM rate
    and the operations over the fp32 rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def vq_bound(n: int, d: int, k: int) -> Tuple[float, str]:
    """vq_lookup: z and E in, q and idx out; the distances and code
    norms."""
    return bound(4 * (n * d + k * d + n * d + n), 2 * n * k * d + 2 * k * d)


def indices_bound(n: int, d: int, k: int) -> Tuple[float, str]:
    """vq_indices: z and E in, idx out; the distance products (the code
    norms, 2 K D, are below the rounding of the bound and left out)."""
    return bound(4 * (n * d + k * d + n), 2 * n * k * d)


def conv_flops(kind: str, n: int, cin: int, cout: int, k: int, stride: int,
               pad: int, h: int, w: int) -> Tuple[int, Tuple[int, int]]:
    """(forward operations, output (h, w)) of one conv or transposed conv
    over an (n, cin, h, w) input."""
    if kind == "conv":
        ho = (h + 2 * pad - k) // stride + 1
        wo = (w + 2 * pad - k) // stride + 1
        return 2 * n * cout * ho * wo * cin * k * k, (ho, wo)
    ho = (h - 1) * stride - 2 * pad + k
    wo = (w - 1) * stride - 2 * pad + k
    return 2 * n * cin * h * w * cout * k * k, (ho, wo)


def _table_flops(table, n, h, w, first_needs_no_grad):
    """(forward, backward) conv operations of a layer table, and the output
    (h, w)."""
    fwd = bwd = 0
    first = first_needs_no_grad
    for layer in ref.flat_layers(table):
        if layer[0] == "bn":
            continue
        kind, _, cin, cout, k, s, p = layer
        ops, (ho, wo) = conv_flops(kind, n, cin, cout, k, s, p, h, w)
        fwd += ops
        bwd += ops if first else 2 * ops        # weight grad (+ input grad)
        first = False
        h, w = ho, wo
    return fwd, bwd, (h, w)


def batch_flops(cfg: Dict, rows: int, size: int, train: bool) -> int:
    """Operations of one batch of ``rows`` patches of size^2 through the
    model: forward and backward for a training step, forward for a
    validation step."""
    arch = ref.architecture(cfg)
    enc_f, enc_b, (h, w) = _table_flops(arch["enc"], rows, size, size, True)
    dec_f, dec_b, _ = _table_flops(arch["dec"], rows, h, w, False)
    d, k = cfg["num_hiddens"], cfg["num_embeddings"]
    latent = h * w * d
    codes = 2 * rows * h * w * k * d
    gram = 2 * rows * rows * latent
    total = enc_f + dec_f + codes + gram
    if train:
        total += enc_b + dec_b + gram
    return total


def latent_grid(cfg: Dict, size: int) -> Tuple[int, int]:
    """The (h, w) of the encoder's output for size^2 patches."""
    arch = ref.architecture(cfg)
    return _table_flops(arch["enc"], 1, size, size, True)[2]


def epoch_flops(cfg: Dict, train_batches: Sequence[int],
                val_batches: Sequence[int], size: int) -> int:
    """Operations of one epoch: its training and validation batches (rows
    of the global batch each)."""
    return sum(batch_flops(cfg, b, size, True) for b in train_batches) + \
        sum(batch_flops(cfg, b, size, False) for b in val_batches)
