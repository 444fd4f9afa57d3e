"""dynamorph_tpu_torch — the PyTorch/CUDA port of dynamorph_tpu for NVIDIA
Hopper GPUs (H100).

It stands alone beside the JAX package: it imports ``torch``, never ``jax``,
and nothing of ``dynamorph_tpu``. It writes the same artifacts (pickles,
reference torch ``state_dict`` names). Plain tensor code is PyTorch; each
Pallas kernel of the JAX package becomes a hand-written CUDA kernel under
``ops/csrc``, built with ``nvcc`` at first use.

- ``dynamorph_tpu_torch.core``     constants, device resolution, stage timer
- ``dynamorph_tpu_torch.config``   typed YAML config system
- ``dynamorph_tpu_torch.io``       pickle / compact artifact IO, site names,
                                   PNG writing, TIFF reading
- ``dynamorph_tpu_torch.nn``       JAX-to-torch weight layout converters
- ``dynamorph_tpu_torch.ops``      VQ codebook search (CUDA kernels + plain)
- ``dynamorph_tpu_torch.models``   VQ-VAE z16 / z32 and the U-Net as
                                   ``nn.Module``s, the JAX weight bridge
- ``dynamorph_tpu_torch.seg``      U-Net segmentation inference (``Segment``,
                                   tiled ensemble and direct mode)
- ``dynamorph_tpu_torch.pipeline`` the stages, raw TIFFs to PCs, and the
                                   staged orchestrator (``run_pipeline``)
- ``dynamorph_tpu_torch.reduce``   PCA and native UMAP
- ``dynamorph_tpu_torch.train``    VQ-VAE training (``train_vqvae``)
- ``dynamorph_tpu_torch.cli``      ``run_preproc``, ``run_segmentation``,
                                   ``run_patch``, ``run_vae``,
                                   ``run_training``, ``run_dim_reduction``,
                                   ``run_pipeline``, ``convert_storage``

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
