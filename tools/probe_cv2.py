"""Record the installed OpenCV's version and whether it has KAZE.

``analysis/kaze.py`` is held against ``cv2.KAZE_create`` wherever the
installed cv2 has it (``tests/test_torch_kaze_oracle.py``); opencv-python
5.0 has none. Run from the repo root on any machine:

    python3 tools/probe_cv2.py

One JSON line to standard output: ``cv2_version`` (null when cv2 does not
import), ``has_kaze``, and the Python, numpy and torch versions beside it.
"""
from __future__ import annotations

import json
import platform


def probe():
    out = {"python": platform.python_version()}
    try:
        import numpy
        out["numpy"] = numpy.__version__
    except ImportError:
        out["numpy"] = None
    try:
        import torch
        out["torch"] = torch.__version__
    except ImportError:
        out["torch"] = None
    try:
        import cv2
    except ImportError as e:
        out.update(cv2_version=None, has_kaze=False, error=str(e))
        return out
    out["cv2_version"] = cv2.__version__
    out["has_kaze"] = hasattr(cv2, "KAZE_create")
    if out["has_kaze"]:
        import numpy as np
        rng = np.random.default_rng(0)
        img = (rng.random((64, 64)) * 255).astype(np.uint8)
        kps = cv2.KAZE_create().detect(img, None)
        out["kaze_keypoints_on_noise"] = len(kps)
    return out


if __name__ == "__main__":
    print(json.dumps(probe()))
