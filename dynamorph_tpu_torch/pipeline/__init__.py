"""Pipeline stages of the port: semantic and instance segmentation, patch
extraction, tracking, VAE dataset assembly, latent encoding and trajectory
matching."""
