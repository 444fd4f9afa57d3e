"""VQ-VAE training: data utilities, steps, the trainer, checkpoints and
metrics (the port of ``dynamorph_tpu/train``), on one device or
data-parallel over the ranks of a process group, with the
trajectory-sharded loss (``sharded_loss``)."""
