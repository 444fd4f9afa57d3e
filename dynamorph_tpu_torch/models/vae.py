"""VAE, IWAE and AAE latent models as ``nn.Module``s — the port of
``dynamorph_tpu/models/vae.py`` (reference HiddenStateExtractor/vae.py:
477-616 VAE, :619-697 IWAE, :700-857 AAE).

All three share the VQ-VAE z16 encoder trunk and decoder
(``models/common.py``), at the reference's ``state_dict`` names: ``enc.*``
(the VAE family adds the 1x1 widening conv ``enc.13``, mean and log-std
halves), ``dec.*``, the AAE's discriminator ``enc_d.*`` and the
``channel_var`` buffer, so a reference ``model.pt`` loads with
``strict=True``.

API, NCHW at the boundary as in the JAX package:
    z_before, z_after, None = model.encode(x)     # z_mean twice (AAE: z)
    decoded, losses = model.apply(x, train=False, time_matching_mat=...,
                                  batch_mask=..., generator=..., eps=...)

Noise (the reparameterisation draws, the discriminator's dropout, the AAE
prior) comes from an explicit ``torch.Generator`` on the model's device, or
is given by the caller (``eps``, ``fixed_eps``, ``z_prior``), never from
torch's global generator. ``train`` decides how batch norm runs, as in
``models/vqvae.py``. The passes run under ``core.device.fp32_strict``.
Under a data-parallel step (``core.mesh.collective_scope``) the losses are
the global batch's, as the VQ-VAEs' are, and each rank keeps its rows of
the global batch's noise draw.

Quirks of the reference kept, as the JAX package keeps them: the
reconstruction loss is a sum, the reported ``recon_loss`` is divided by
``B * 32768``, ``z_std = exp(0.5 * z_logstd)``, and the time-matching loss
reads ``z_mean``.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from ..core.device import fp32_strict
from ..core.mesh import all_reduce_sum, global_mean, global_rows, rank_rows
from . import common


def _normal(shape, like: torch.Tensor,
            generator: Optional[torch.Generator],
            batch_axis: int = 0) -> torch.Tensor:
    """Standard normal noise of ``shape``; under a data-parallel step the
    global batch's draw along ``batch_axis``, of which this rank keeps its
    rows, so the ranks draw what one process would."""
    shape = list(shape)
    shape[batch_axis] = global_rows(shape[batch_axis])
    return rank_rows(torch.randn(shape, generator=generator,
                                 device=like.device, dtype=like.dtype),
                     batch_axis)


class _Z16Latent(nn.Module):
    """The shared trunk of the three models: hyperparameters, encoder,
    decoder and ``channel_var``. Ends its ``__init__`` in eval mode."""

    def __init__(self, num_inputs: int = 2, num_hiddens: int = 16,
                 num_residual_hiddens: int = 32, num_residual_layers: int = 2,
                 weight_recon: float = 1.0, weight_matching: float = 0.005,
                 w_a: float = 1.1, w_t: float = 0.1, w_n: float = -0.5,
                 margin: float = 0.5, channel_var=(1.0, 1.0),
                 extra_out: int = 0):
        super().__init__()
        self.num_inputs = num_inputs
        self.num_hiddens = num_hiddens
        self.num_residual_hiddens = num_residual_hiddens
        self.num_residual_layers = num_residual_layers
        self.weight_recon = weight_recon
        self.weight_matching = weight_matching
        self.w_a, self.w_t, self.w_n, self.margin = w_a, w_t, w_n, margin
        self.register_buffer(
            "channel_var", common.channel_var_buffer(channel_var, num_inputs))
        self.enc = common.z16_encoder(num_inputs, num_hiddens,
                                      num_residual_hiddens,
                                      num_residual_layers, extra_out)
        self.dec = common.z16_decoder(num_inputs, num_hiddens)
        # the time-matching loss, None for common.time_matching_loss (as
        # the VQ-VAEs' field)
        self.tm_loss_fn = None

    def _tm(self, z: torch.Tensor, time_matching_mat) -> torch.Tensor:
        if time_matching_mat is None:
            return torch.zeros((), dtype=torch.float32, device=z.device)
        return (self.tm_loss_fn or common.time_matching_loss)(
            z.reshape(z.shape[0], -1), time_matching_mat,
            self.w_a, self.w_t, self.w_n, self.margin)


class VAEModel(_Z16Latent):
    """Regular VAE (reference vae.py:477-616)."""

    def __init__(self, num_inputs: int = 2, num_hiddens: int = 16,
                 weight_kld: float = 1.0, **kw):
        super().__init__(num_inputs=num_inputs, num_hiddens=num_hiddens,
                         extra_out=2 * num_hiddens, **kw)
        self.weight_kld = weight_kld
        self.eval()

    def _mean_logstd(self, x: torch.Tensor):
        z = common.apply_z16_encoder(self.enc, x)
        return z[:, :self.num_hiddens], z[:, self.num_hiddens:]

    def apply(self, x: torch.Tensor, train: bool = False,
              time_matching_mat=None, batch_mask=None,
              generator: Optional[torch.Generator] = None,
              eps: Optional[torch.Tensor] = None):
        """Forward with the reference's losses: (decoded NCHW, losses).

        The sample is ``z_mean + exp(0.5 z_logstd) * eps``, with ``eps``
        (B, num_hiddens, H, W) given or drawn from ``generator``, in eval
        mode too (as the JAX package's ``apply`` draws with its key)."""
        with torch.set_grad_enabled(train), fp32_strict(), \
                common.batch_stats(self, train):
            z_mean, z_logstd = self._mean_logstd(x)
            z_std = torch.exp(0.5 * z_logstd)
            if eps is None:
                eps = _normal(z_std.shape, z_std, generator)
            z_sample = z_mean + z_std * eps
            kld = all_reduce_sum(-0.5 * torch.sum(
                1 + z_logstd - z_mean ** 2 - torch.exp(z_logstd)))
            decoded = self.dec(z_sample)
            recon = all_reduce_sum(common.masked_recon_loss(
                decoded, x, batch_mask, self.channel_var, reduction="sum"))
            total = self.weight_recon * recon + self.weight_kld * kld
            tm = self._tm(z_mean, time_matching_mat)
            if time_matching_mat is not None:
                total = total + self.weight_matching * tm
        losses = {
            "recon_loss": recon / (global_rows(x.shape[0]) * 32768),
            "KLD": kld,
            "time_matching_loss": tm,
            "total_loss": total,
            "perplexity": torch.zeros((), device=x.device),
        }
        return decoded, losses

    def predict(self, x: torch.Tensor):
        """The deterministic path: decode ``z_mean`` (reference
        vae.py:600-616). Returns (decoded, {"recon_loss": mean error})."""
        with torch.no_grad(), fp32_strict(), common.batch_stats(self, False):
            z_mean, _ = self._mean_logstd(x)
            decoded = self.dec(z_mean)
            recon = torch.mean((decoded - x) ** 2 / self.channel_var)
        return decoded, {"recon_loss": recon}

    def encode(self, x: torch.Tensor):
        """(B, C, H, W) -> (z_mean, z_mean, None)."""
        with torch.no_grad(), fp32_strict(), common.batch_stats(self, False):
            z_mean, _ = self._mean_logstd(x)
        return z_mean, z_mean, None


class IWAEModel(VAEModel):
    """Importance-weighted autoencoder (reference vae.py:619-697), ``k``
    samples a patch."""

    def __init__(self, num_inputs: int = 2, num_hiddens: int = 16,
                 k: int = 5, **kw):
        super().__init__(num_inputs=num_inputs, num_hiddens=num_hiddens,
                         **kw)
        self.k = k

    def _log_weights(self, x, mask, z_mean, z_logstd, eps):
        """Per sample and patch, ``log w = log p(x|z) + log p(z) -
        log q(z|x)`` with the reference's density conventions, and the
        reconstruction error: both (B, k). The k samples go through the
        decoder as one batch of k * B (it has no batch norm)."""
        z_std = torch.exp(0.5 * z_logstd)
        zs = z_mean[None] + z_std[None] * eps            # (k, B, D, H, W)
        kb = zs.shape[:2]
        decoded = self.dec(zs.reshape((-1,) + tuple(zs.shape[2:])))
        decoded = decoded.reshape(kb + tuple(decoded.shape[1:]))
        dims = (2, 3, 4)
        log_p_x_z = -torch.sum((decoded * mask - x * mask) ** 2 /
                               self.channel_var, dim=dims)
        log_p_z = -torch.sum(0.5 * zs ** 2, dim=dims)
        log_q_z_x = -torch.sum(0.5 * eps ** 2 + z_logstd[None], dim=dims)
        return (log_p_x_z + log_p_z - log_q_z_x).T, (-log_p_x_z).T

    def _eps(self, z_mean, eps, generator):
        if eps is None:
            return _normal((self.k,) + tuple(z_mean.shape), z_mean,
                           generator, batch_axis=1)
        return torch.as_tensor(eps, device=z_mean.device)

    def apply(self, x: torch.Tensor, train: bool = False,
              time_matching_mat=None, batch_mask=None,
              generator: Optional[torch.Generator] = None,
              fixed_eps: Optional[torch.Tensor] = None):
        """The normalised-weight training objective (reference
        vae.py:664-676): returns (None, losses). ``fixed_eps`` (k, B,
        num_hiddens, H, W) replaces the draws from ``generator``."""
        mask = torch.ones_like(x) if batch_mask is None else batch_mask
        with torch.set_grad_enabled(train), fp32_strict(), \
                common.batch_stats(self, train):
            z_mean, z_logstd = self._mean_logstd(x)
            tm = self._tm(z_mean, time_matching_mat)
            log_ws, recon_losses = self._log_weights(
                x, mask, z_mean, z_logstd,
                self._eps(z_mean, fixed_eps, generator))
            ws = torch.exp(log_ws - torch.max(log_ws, dim=1,
                                               keepdim=True).values)
            norm_ws = (ws / torch.sum(ws, dim=1, keepdim=True)).detach()
            total = -all_reduce_sum(torch.sum(norm_ws * log_ws)) + \
                self.weight_matching * tm
            recon = all_reduce_sum(torch.sum(norm_ws * recon_losses))
        losses = {
            "recon_loss": recon / (global_rows(x.shape[0]) * 32768),
            "time_matching_loss": tm,
            "total_loss": total,
            "perplexity": torch.zeros((), device=x.device),
        }
        return None, losses

    def log_likelihood_bound(self, x: torch.Tensor, batch_mask=None,
                             generator: Optional[torch.Generator] = None,
                             eps: Optional[torch.Tensor] = None):
        """``mean_B [logsumexp_k log w - log k]`` with the eval-mode
        encoder (``IWAEModel.log_likelihood_bound``,
        dynamorph_tpu/models/vae.py:219-273, whose caveat holds here: the
        q-density subtracts ``z_logstd`` while the sampled std is
        ``exp(0.5 z_logstd)``, so the value compares k values or
        checkpoints of one model, never as an absolute likelihood)."""
        mask = torch.ones_like(x) if batch_mask is None else batch_mask
        with torch.no_grad(), fp32_strict(), common.batch_stats(self, False):
            z_mean, z_logstd = self._mean_logstd(x)
            log_ws, _ = self._log_weights(x, mask, z_mean, z_logstd,
                                          self._eps(z_mean, eps, generator))
            return torch.mean(torch.logsumexp(log_ws, dim=1) -
                              math.log(float(self.k)))


class AAEModel(_Z16Latent):
    """Adversarial autoencoder (reference vae.py:700-857). The
    discriminator ``enc_d`` (:759-778) scores 16x16 latents: 1x1 conv,
    three 4x4 stride-2 convs with batch norm and ReLU, flatten (NCHW,
    channel-major), then fc - dropout(0.25) - ReLU - fc - dropout(0.25) -
    ReLU - fc - sigmoid. Only ``adversarial_loss`` uses it; training
    through ``train_vqvae`` runs ``apply``, which has no adversarial term
    (as in the JAX package)."""

    _KEEP = 0.75

    def __init__(self, num_inputs: int = 2, num_hiddens: int = 16, **kw):
        super().__init__(num_inputs=num_inputs, num_hiddens=num_hiddens,
                         **kw)
        nh = num_hiddens
        self.enc_d = nn.Sequential(
            nn.Conv2d(nh, nh // 2, 1),                  # 0
            nn.Conv2d(nh // 2, nh // 2, 4, 2, 1),       # 1
            nn.BatchNorm2d(nh // 2),                    # 2
            nn.ReLU(),                                  # 3
            nn.Conv2d(nh // 2, nh // 2, 4, 2, 1),       # 4
            nn.BatchNorm2d(nh // 2),                    # 5
            nn.ReLU(),                                  # 6
            nn.Conv2d(nh // 2, nh // 2, 4, 2, 1),       # 7
            nn.BatchNorm2d(nh // 2),                    # 8
            nn.ReLU(),                                  # 9
            nn.Flatten(),                               # 10
            nn.Linear(nh * 2, nh * 8),                  # 11
            nn.Dropout(1 - self._KEEP),                 # 12
            nn.ReLU(),                                  # 13
            nn.Linear(nh * 8, nh),                      # 14
            nn.Dropout(1 - self._KEEP),                 # 15
            nn.ReLU(),                                  # 16
            nn.Linear(nh, 1),                           # 17
            nn.Sigmoid(),                               # 18
        )
        self.eval()

    def _encode(self, x):
        return common.apply_z16_encoder(self.enc, x)

    def discriminate(self, z: torch.Tensor, train: bool,
                     generator: Optional[torch.Generator] = None,
                     keep: Optional[Sequence[torch.Tensor]] = None):
        """The discriminator's score in (0, 1), (B, 1) (``_apply_disc``,
        dynamorph_tpu/models/vae.py:325-351). Batch norm runs as the
        caller's block set it; with ``train`` each dropout keeps a unit
        with probability 0.75 and scales it by 1 / 0.75. The two boolean
        keep masks, (B, 8 nh) and (B, nh), are ``keep`` or drawn from
        ``generator``."""
        d = self.enc_d
        h = d[:11](z)
        for i, (fc, act) in enumerate(((d[11], d[13]), (d[14], d[16]))):
            h = fc(h)
            if train:
                k = torch.rand(h.shape, generator=generator,
                               device=h.device) < self._KEEP \
                    if keep is None else keep[i].to(h.device)
                h = torch.where(k, h / self._KEEP, 0.0)
            h = act(h)
        return d[18](d[17](h))

    def apply(self, x: torch.Tensor, train: bool = False,
              time_matching_mat=None, batch_mask=None):
        """Autoencoder forward: (decoded NCHW, losses); unlike the VAE's,
        the reconstruction loss is a mean, as in the JAX package."""
        with torch.set_grad_enabled(train), fp32_strict(), \
                common.batch_stats(self, train):
            z = self._encode(x)
            decoded = self.dec(z)
            recon = global_mean(common.masked_recon_loss(
                decoded, x, batch_mask, self.channel_var))
            total = self.weight_recon * recon
            tm = self._tm(z, time_matching_mat)
            if time_matching_mat is not None:
                total = total + self.weight_matching * tm
        losses = {
            "recon_loss": recon,
            "time_matching_loss": tm,
            "total_loss": total,
            "perplexity": torch.zeros((), device=x.device),
        }
        return decoded, losses

    def adversarial_loss(self, x: torch.Tensor, train: bool = True,
                         generator: Optional[torch.Generator] = None,
                         z_prior: Optional[torch.Tensor] = None,
                         keep: Optional[Sequence[torch.Tensor]] = None):
        """Generator and discriminator losses (reference vae.py:834-853;
        ``adversarial_loss``, dynamorph_tpu/models/vae.py:376-404). The
        encoder's latents and a standard-normal prior sample (``z_prior``,
        or drawn from ``generator``) go through the discriminator in that
        order, so its running statistics move as the reference's two
        sequential calls move them. ``keep`` gives the four dropout masks
        in the order they are applied (the data's two, then the prior's);
        without it they are drawn from ``generator``."""
        tiny = 1e-9
        with torch.set_grad_enabled(train), fp32_strict(), \
                common.batch_stats(self, train):
            z_data = self._encode(x)
            if z_prior is None:
                z_prior = _normal(z_data.shape, z_data, generator)
            s_data = self.discriminate(z_data, train, generator,
                                       None if keep is None else keep[:2])
            s_prior = self.discriminate(z_prior, train, generator,
                                        None if keep is None else keep[2:])
            g_loss = -torch.mean(torch.log(s_data + tiny))
            d_loss = -torch.mean(torch.log(s_prior + tiny) +
                                 torch.log(1 - s_data.detach() + tiny))
        return {"generator_loss": g_loss, "descriminator_loss": d_loss,
                "score": torch.mean(s_data)}

    def encode(self, x: torch.Tensor):
        """(B, C, H, W) -> (z, z, None)."""
        with torch.no_grad(), fp32_strict(), common.batch_stats(self, False):
            z = self._encode(x)
        return z, z, None
