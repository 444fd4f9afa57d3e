"""Pipeline stages of the port: preprocessing, semantic and instance
segmentation, patch extraction, tracking, VAE dataset assembly, latent
encoding, trajectory matching and dimensionality reduction, and the staged
orchestrator that runs them."""
