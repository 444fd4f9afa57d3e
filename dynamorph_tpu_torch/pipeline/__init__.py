"""Pipeline stages of the port: latent encoding and semantic
segmentation."""
