"""dynamorph_tpu_torch — the PyTorch/CUDA port of dynamorph_tpu for NVIDIA
Hopper GPUs (H100).

It stands alone beside the JAX package: it imports ``torch``, never ``jax``,
and nothing of ``dynamorph_tpu``. It writes the same artifacts (pickles,
reference torch ``state_dict`` names). Plain tensor code is PyTorch; each
Pallas kernel of the JAX package becomes a hand-written CUDA kernel under
``ops/csrc``, built with ``nvcc`` at first use.

- ``dynamorph_tpu_torch.core``     constants, device resolution, stage timer
- ``dynamorph_tpu_torch.config``   typed YAML config system
- ``dynamorph_tpu_torch.io``       pickle / compact artifact IO, site names
- ``dynamorph_tpu_torch.nn``       JAX-to-torch weight layout converters
- ``dynamorph_tpu_torch.ops``      VQ codebook search (CUDA kernels + plain)
- ``dynamorph_tpu_torch.models``   VQ-VAE z16 / z32 as ``nn.Module``s
- ``dynamorph_tpu_torch.pipeline`` latent encoding (``process_vae``)
- ``dynamorph_tpu_torch.train``    VQ-VAE training (``train_vqvae``)
- ``dynamorph_tpu_torch.cli``      ``run_vae -m process``, ``run_training``

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
