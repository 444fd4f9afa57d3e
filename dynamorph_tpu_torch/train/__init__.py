"""VQ-VAE training: data utilities, steps, the trainer, checkpoints and
metrics (the port of ``dynamorph_tpu/train`` for one device)."""
