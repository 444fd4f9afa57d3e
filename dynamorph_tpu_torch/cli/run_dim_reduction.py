"""PCA/UMAP dimensionality reduction over latent vectors (reference
run_dim_reduction.py:314-345).

Usage: python -m dynamorph_tpu_torch.cli.run_dim_reduction -m {pca,umap}
       -c <config.yml> [--device cuda|cpu]

The fit pools the latents of every input directory and runs on the device
(the PCA's SVD; the native UMAP's kNN graph and SGD); the transform
(``fit_model: false``, PCA only) runs on the host. Under ``--multihost``
rank 0 alone fits and transforms, and every rank leaves through a barrier,
also when the fit raised (dynamorph_tpu/cli/run_dim_reduction.py:10-33).
"""
from __future__ import annotations

from typing import Optional, Sequence

from ..core import mesh
from ..core.device import resolve_device
from ..pipeline.dim_reduction import dim_reduction
from .common import parse_method_config, setup_logging


def main(argv: Optional[Sequence[str]] = None) -> None:
    setup_logging()
    method, config, device = parse_method_config(
        choices=["pca", "umap"], argv=argv, default="pca")
    dev = resolve_device(device)
    dr = config.dim_reduction
    try:
        if mesh.is_main_process():
            dim_reduction(method, dr.input_dirs,
                          dr.output_dirs or dr.input_dirs, dr.weights_dir,
                          config, device=dev)
    finally:
        mesh.barrier("dim-reduction")


if __name__ == "__main__":
    main()
