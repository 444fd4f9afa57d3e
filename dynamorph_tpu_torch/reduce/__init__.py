"""Dimensionality reduction of latent vectors: PCA (SVD on the card) and
UMAP (the native fit on the card)."""
