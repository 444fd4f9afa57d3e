"""Pipeline stages of the port (latent encoding so far)."""
