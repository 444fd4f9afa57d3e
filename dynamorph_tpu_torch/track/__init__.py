"""Instance segmentation (foreground clustering), frame-to-frame LAP
tracking and trajectory relations: host stages, ported from
``dynamorph_tpu/track``."""
