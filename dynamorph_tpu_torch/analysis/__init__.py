"""Analysis after the latents: state clustering (with the port's own
k-means), trajectory dynamics (MSD), reconstruction evaluation and PC-sample
montages. The JAX package's ``analysis/__init__`` imports ``morphology``
(cv2, KAZE); the port has no cv2, so that module is not ported and not
imported here."""
