"""Device ops: ``vq.py`` and ``batch_norm.py`` with their hand-written CUDA
kernels (``csrc/``) and a plain PyTorch version beside each; ``patch.py``
(the per-frame patch program) and ``geometry.py`` (cv2's warp, resize and
flip) in plain PyTorch, no kernel of their own."""
