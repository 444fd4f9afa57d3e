"""VQ-VAE models (z16 / z32) as ``nn.Module``s — the port of
``dynamorph_tpu/models/vqvae.py``.

Module names follow the reference (HiddenStateExtractor/vae.py:216-346 for
z16, :348-474 for z32), so the ``state_dict`` of a reference ``model.pt``
loads with ``strict=True``: ``enc.*``, ``vq.w.weight``, ``dec.*`` and the
``channel_var`` buffer.

API (both models), NCHW at the boundary as in the JAX package:
    z_before, z_after, idx = model.encode(x)     # idx (B, H, W) int32
    decoded = model.decode(z)
    decoded, losses = model.apply(x, train=False,
                                  time_matching_mat=..., batch_mask=...)

``train`` decides how batch norm runs, not the module's mode: for the call,
every submodule is put in the mode ``train`` names and then set back, so
``model.train()`` / ``model.eval()`` change no result. ``encode`` and
``decode`` always use the running statistics. ``apply(train=True)`` keeps
autograd live, normalises with the batch statistics and updates the
running buffers in place (torch's momentum 0.1, unbiased variance): those
buffers are the JAX package's ``new_state``.

The passes run under ``core.device.fp32_strict``: full fp32, no TF32, as in
the JAX reference.

Under a data-parallel step (``core.mesh.collective_scope``) ``apply``'s
losses are the global batch's: the means are averaged over the ranks'
equal shards, the perplexity counts codes over every rank's rows, and the
time-matching loss is ``tm_loss_fn`` (``train.sharded_loss.
make_traj_sharded_tm_loss`` for trajectory-packed shards) or, when that is
None, the dense loss over the gathered latents.
"""
from __future__ import annotations

import torch
from torch import nn

from ..core.device import fp32_strict
from ..core.mesh import all_reduce_sum, global_mean
from ..nn.batchnorm import BatchNorm2d
from ..ops.vq import (PRECISIONS, gather_codes, perplexity_from_counts,
                      vq_codebook_counts, vq_indices, vq_lookup)
from . import common


class _Codebook(nn.Module):
    """Holds the codebook as ``w`` (an ``nn.Embedding``), the reference's
    ``vq.w.weight``."""

    def __init__(self, num_embeddings: int, embedding_dim: int):
        super().__init__()
        self.w = nn.Embedding(num_embeddings, embedding_dim)


def _lookup_nchw(z: torch.Tensor, codebook: torch.Tensor):
    """vq_lookup on NCHW latents: (B, D, H, W) -> (q NCHW, idx (B, H, W))."""
    q, idx = vq_lookup(z.permute(0, 2, 3, 1).contiguous(), codebook)
    return q.permute(0, 3, 1, 2), idx


class VQVAEBase(nn.Module):
    def __init__(self, num_inputs: int = 2, num_hiddens: int = 16,
                 num_residual_hiddens: int = 32, num_residual_layers: int = 2,
                 num_embeddings: int = 64, commitment_cost: float = 0.25,
                 weight_recon: float = 1.0, weight_commitment: float = 1.0,
                 weight_matching: float = 0.005, w_a: float = 1.1,
                 w_t: float = 0.1, w_n: float = -0.5, margin: float = 0.5,
                 channel_var=(1.0, 1.0), vq_train_precision: str = "high"):
        super().__init__()
        if vq_train_precision not in PRECISIONS:
            raise ValueError(f"vq_train_precision {vq_train_precision!r} not "
                             f"in {sorted(PRECISIONS)}")
        self.num_inputs = num_inputs
        self.num_hiddens = num_hiddens
        self.num_residual_hiddens = num_residual_hiddens
        self.num_residual_layers = num_residual_layers
        self.num_embeddings = num_embeddings
        self.commitment_cost = commitment_cost
        self.weight_recon = weight_recon
        self.weight_commitment = weight_commitment
        self.weight_matching = weight_matching
        self.w_a, self.w_t, self.w_n, self.margin = w_a, w_t, w_n, margin
        # the training-path codebook search (ops.vq.PRECISIONS: all fp32)
        self.vq_train_precision = vq_train_precision
        self.vq = _Codebook(num_embeddings, num_hiddens)
        # the time-matching loss, None for common.time_matching_loss: the
        # drop-in field of dynamorph_tpu/models/vqvae.py:64-66
        self.tm_loss_fn = None
        self.register_buffer(
            "channel_var", common.channel_var_buffer(channel_var, num_inputs))

    # subclasses: _encode(x), _decode(z), _recon_weighted, _tm_uses_after;
    # each ends its __init__ in eval mode

    def encode(self, x: torch.Tensor):
        """(B, C, H, W) -> (z_before, z_after, indices), channel-first
        latents. The ``process_VAE`` hot path (reference
        pipeline/patch_VAE.py:445-452), batched."""
        with torch.no_grad(), fp32_strict(), common.batch_stats(self, False):
            z_before = self._encode(x)
            z_after, idx = _lookup_nchw(z_before, self.vq.w.weight)
        return z_before, z_after, idx

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        with torch.no_grad(), fp32_strict(), common.batch_stats(self, False):
            return self._decode(z)

    def _vq(self, z_before: torch.Tensor, train: bool):
        """Codebook search, straight-through and commitment loss, perplexity
        (``_vq``, dynamorph_tpu/models/vqvae.py:76-104). Training searches
        with the indices-only kernel on detached inputs and re-gathers the
        rows with ``gather_codes``, so the codebook gets its gradient; eval
        uses the lookup kernel's rows."""
        codebook = self.vq.w.weight
        if train:
            idx = vq_indices(z_before.permute(0, 2, 3, 1), codebook,
                             precision=self.vq_train_precision)
            q = gather_codes(codebook, idx).permute(0, 3, 1, 2)
        else:
            q, idx = _lookup_nchw(z_before, codebook)
        z_after, c_loss = common.vq_losses(z_before, q, self.commitment_cost)
        perplexity = perplexity_from_counts(all_reduce_sum(
            vq_codebook_counts(idx, self.num_embeddings)))
        return z_after, global_mean(c_loss), perplexity

    def apply(self, x: torch.Tensor, train: bool = False,
              time_matching_mat=None, batch_mask=None):
        """Forward with the reference's losses: returns (decoded NCHW,
        losses dict).

        ``train=False``: no autograd, running batch-norm statistics.
        ``train=True``: autograd live, batch statistics, and the running
        buffers updated in place. ``time_matching_mat`` is the (B, B)
        relation block (uint8 or float, codes 0/1/2); ``batch_mask`` is
        (B, C, H, W) float."""
        with torch.set_grad_enabled(train), fp32_strict(), \
                common.batch_stats(self, train):
            z_before = self._encode(x)
            z_after, c_loss, perplexity = self._vq(z_before, train)
            decoded = self._decode(z_after)
            recon = global_mean(common.masked_recon_loss(
                decoded, x, batch_mask, self.channel_var))
            if self._recon_weighted:
                total = self.weight_recon * recon + \
                    self.weight_commitment * c_loss
            else:
                total = recon + c_loss
            tm = torch.zeros((), dtype=torch.float32, device=x.device)
            if time_matching_mat is not None:
                z_tm = z_after if self._tm_uses_after else z_before
                tm = (self.tm_loss_fn or common.time_matching_loss)(
                    z_tm.reshape(z_tm.shape[0], -1), time_matching_mat,
                    self.w_a, self.w_t, self.w_n, self.margin)
                total = total + self.weight_matching * tm
        losses = {
            "recon_loss": recon,
            "commitment_loss": c_loss,
            "time_matching_loss": tm,
            "perplexity": perplexity,
            "total_loss": total,
        }
        return decoded, losses


class VQVAEz16(VQVAEBase):
    """3x downsample: 128x128 input -> 16x16 x num_hiddens latent grid.

    Reference spec: HiddenStateExtractor/vae.py:216-346 (enc :273-286,
    dec :288-295). Time-matching loss uses z_before (pre-VQ, vae.py:323).
    """

    _recon_weighted = True
    _tm_uses_after = False

    def __init__(self, num_inputs: int = 2, num_hiddens: int = 16, **kw):
        super().__init__(num_inputs=num_inputs, num_hiddens=num_hiddens, **kw)
        self.enc = common.z16_encoder(num_inputs, num_hiddens,
                                      self.num_residual_hiddens,
                                      self.num_residual_layers)
        self.dec = common.z16_decoder(num_inputs, num_hiddens)
        self.eval()

    def _encode(self, x):
        return common.apply_z16_encoder(self.enc, x)

    def _decode(self, z):
        return self.dec(z)


class VQVAEz32(VQVAEBase):
    """2x downsample: 128x128 input -> 32x32 x num_hiddens latent grid.

    Reference spec: HiddenStateExtractor/vae.py:348-474 (enc :401-407,
    dec :409-414). Recon/commitment unweighted (vae.py:440), and the
    time-matching loss uses z_after (post-VQ, vae.py:444). The ReLUs at
    ``enc.2`` and ``dec.3`` are folded into the batch norms before them
    (``BatchNorm2d(relu=True)``); their slots are ``nn.Identity``.
    """

    _recon_weighted = False
    _tm_uses_after = True

    def __init__(self, num_inputs: int = 2, num_hiddens: int = 16, **kw):
        super().__init__(num_inputs=num_inputs, num_hiddens=num_hiddens, **kw)
        nh, ni = num_hiddens, num_inputs
        self.enc = nn.Sequential(
            nn.Conv2d(ni, nh // 2, 4, 2, 1),            # 0
            BatchNorm2d(nh // 2, relu=True),            # 1
            nn.Identity(),                              # 2
            nn.Conv2d(nh // 2, nh, 4, 2, 1),            # 3
            BatchNorm2d(nh),                            # 4
            common.ResidualStack(nh, self.num_residual_hiddens,
                                 self.num_residual_layers),  # 5
        )
        self.dec = nn.Sequential(
            common.ResidualStack(nh, self.num_residual_hiddens,
                                 self.num_residual_layers),  # 0
            nn.ConvTranspose2d(nh, nh // 2, 4, 2, 1),   # 1
            BatchNorm2d(nh // 2, relu=True),            # 2
            nn.Identity(),                              # 3
            nn.ConvTranspose2d(nh // 2, ni, 4, 2, 1),   # 4
        )
        self.eval()

    def _encode(self, x):
        return self.enc(x)

    def _decode(self, z):
        return self.dec(z)
