"""Array conventions and global constants (the same values as the JAX
package's ``core/constants.py``).

Single-cell patch tensors are ``(N, C, H, W)``; the port keeps NCHW inside
as well as at its public functions.

Reference anchors: CHANNEL_MAX — NNsegmentation/data.py:14,
HiddenStateExtractor/vae.py:8; CHANNEL_VAR — HiddenStateExtractor/vae.py:7.
"""
import numpy as np

# Microscopy images are uint16; all intensities are scaled by this.
CHANNEL_MAX = 65535.0

# Per-channel SD used to balance reconstruction loss across channels.
CHANNEL_VAR = np.array([1.0, 1.0])

EPS = 1e-9
