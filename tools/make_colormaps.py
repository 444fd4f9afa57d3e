"""Write ``dynamorph_tpu_torch/analysis/colormaps.npz``: every colour map
that matplotlib registers (``matplotlib.colormaps``, the reversed ``_r``
maps included) as the (N, 3) uint8 table
``Colormap(np.arange(N), bytes=True)[:, :3]`` at the map's own N.

``analysis/raster.py::colormap_lut`` reads the file, so the port draws
matplotlib's colours on machines without matplotlib. Run from the repo
root where matplotlib is installed, and commit the file it writes:

    python3 tools/make_colormaps.py
"""
from __future__ import annotations

import os

import numpy as np

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "dynamorph_tpu_torch", "analysis", "colormaps.npz")


def tables():
    import matplotlib

    out = {}
    for name in sorted(matplotlib.colormaps):
        cmap = matplotlib.colormaps[name]
        out[name] = np.ascontiguousarray(
            cmap(np.arange(cmap.N), bytes=True)[:, :3], np.uint8)
    return out


if __name__ == "__main__":
    import matplotlib

    t = tables()
    np.savez_compressed(OUT, **t)
    print(f"{len(t)} maps from matplotlib {matplotlib.__version__} -> {OUT} "
          f"({os.path.getsize(OUT)} bytes)")
