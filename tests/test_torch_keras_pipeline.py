"""The segmentation stages from a reference-trained Keras ``.h5`` against
the JAX package on the CPU: ``run_segmentation -m segmentation`` (tiled and
direct) with ``segmentation_inference.weights`` pointing at the file, and
the fused seg -> instance -> patch stage with the model its
``build_seg_model`` loads from it.

The weights are ``test_torch_keras_unet``'s (seeded, written with h5py);
the JAX stages get a JAX ``Segment`` built without its jitted init
(``_bare_jax_segment``) that loads the same file itself. Probabilities
within 1e-5, the Keras U-Net's stated tolerance. At most 3 tests: the JAX
tile, frame and fused programs are the cost, queued late.
"""
import os

import numpy as np
import pytest

from dynamorph_tpu.config.schema import (PipelineConfig as JaxPC,
                                         SegmentationInferenceConfig as JaxSI)
from dynamorph_tpu.pipeline import segmentation as jax_pipeline
from dynamorph_tpu.seg.model import Segment as JaxSegment
from dynamorph_tpu_torch.cli import run_segmentation
from dynamorph_tpu_torch.config.schema import (PipelineConfig,
                                               SegmentationInferenceConfig)
from dynamorph_tpu_torch.models.unet_keras import KerasUNet
from dynamorph_tpu_torch.pipeline import fused
from test_keras_import import write_keras_h5
from test_torch_keras_unet import keras_unet_weights
from test_torch_segmentation import _bare_jax_segment
from test_torch_train import _few_threads  # noqa: F401

WINDOW = 32
PROB_ATOL = 1e-5
SITES = ["B2-Site_0", "B2-Site_1"]
N_SUPP = 2


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("keras") / "unet.h5")
    write_keras_h5(path, keras_unet_weights(5))
    return path


def _jax_model(**kw):
    """The JAX stage's Segment, built as its __init__ would be but for the
    jitted init; the stage loads the weights into it."""
    return _bare_jax_segment(JaxSegment, kw["input_shape"])


@pytest.mark.parametrize("mode", ["tiled", "direct"])
def test_run_segmentation_from_h5_matches_jax(weights, tmp_path, monkeypatch,
                                              mode):
    """``run_segmentation -m segmentation --device cpu`` on a two-site raw
    dir ((2, 3, 1, 64, 64) float64 frames) with the ``.h5`` as weights,
    against the JAX package's ``segmentation()`` on a copy under the same
    global numpy seed: ``_NNProbabilities.npy`` within 1e-5."""
    dirs = {k: tmp_path / k for k in ("jax_raw", "port_raw", "supp")}
    for d in dirs.values():
        d.mkdir()
    for i, site in enumerate(SITES):
        stack = np.random.RandomState(60 + i).rand(2, 3, 1, 64, 64) * 65535
        for k in ("jax_raw", "port_raw"):
            np.save(dirs[k] / f"{site}.npy", stack)
    monkeypatch.setattr(jax_pipeline, "Segment", _jax_model)
    cfg = JaxPC(segmentation_inference=JaxSI(
        channels=[0, 1], window_size=WINDOW, num_pred_rnd=N_SUPP,
        weights=weights, inference_mode=mode))
    np.random.seed(9)
    jax_pipeline.segmentation(str(dirs["jax_raw"]), str(dirs["supp"]), None,
                              SITES, cfg)
    yml = tmp_path / "cfg.yml"
    yml.write_text(
        "segmentation_inference:\n"
        f"  raw_dirs: ['{dirs['port_raw']}']\n"
        f"  supp_dirs: ['{dirs['supp']}']\n"
        f"  weights: '{weights}'\n  channels: [0, 1]\n"
        f"  window_size: {WINDOW}\n  num_pred_rnd: {N_SUPP}\n"
        f"  inference_mode: {mode}\n")
    np.random.seed(9)
    run_segmentation.main(["-m", "segmentation", "-c", str(yml),
                           "--device", "cpu"])
    for site in SITES:
        pj = np.load(dirs["jax_raw"] / f"{site}_NNProbabilities.npy")
        pt = np.load(dirs["port_raw"] / f"{site}_NNProbabilities.npy")
        assert pt.shape == pj.shape == (2, 3, 1, 64, 64)
        assert pt.dtype == pj.dtype
        assert not (pt == -1).any()
        np.testing.assert_allclose(pt, pj, atol=PROB_ATOL, rtol=0)
        assert np.ptp(pj) > 0.1
        assert os.path.exists(dirs["port_raw"] / f"{site}_NNpred.png")


def test_fused_stage_from_h5_matches_jax(weights, tmp_path, monkeypatch):
    """The fused stage with the U-Net that ``build_seg_model`` loads from
    the ``.h5`` (the Keras graph): its probabilities within 1e-5 of the
    JAX fused stage's with the JAX model loaded from the same file, on the
    fused tests' 3-frame 64 x 64 site. The JAX stage clusters with the
    port's native grid DBSCAN (sklearn's labels exactly), as in
    ``test_torch_segmentation.py::test_fused_stage_real_unet_matches_jax``.
    """
    import dynamorph_tpu.native.dbscan as jax_dbscan
    from dynamorph_tpu_torch.native.dbscan import grid_dbscan
    from test_torch_fused import SITE, T, _make_site, _run_jax_fused, \
        run_port_fused

    monkeypatch.setattr(jax_dbscan, "grid_dbscan", grid_dbscan)
    cfg = PipelineConfig(segmentation_inference=SegmentationInferenceConfig(
        channels=[0, 1], window_size=WINDOW, weights=weights))
    pm = fused.build_seg_model(cfg, device="cpu")
    assert isinstance(pm.net, KerasUNet)
    jm = _bare_jax_segment(JaxSegment, (2, WINDOW, WINDOW))
    jm.load(weights)
    for name in ("jax", "port"):
        _make_site(tmp_path / name, SITE)
    _run_jax_fused(str(tmp_path / "jax" / f"{SITE}.npy"),
                   str(tmp_path / "jax" / "supp"), monkeypatch, model=jm)
    run_port_fused(str(tmp_path / "port" / f"{SITE}.npy"),
                   str(tmp_path / "port" / "supp"), model=pm)
    ours = np.load(tmp_path / "port" / f"{SITE}_NNProbabilities.npy")
    ref = np.load(tmp_path / "jax" / f"{SITE}_NNProbabilities.npy")
    assert ours.shape == ref.shape == (T, 3, 1, 64, 64)
    np.testing.assert_allclose(ours, ref, atol=PROB_ATOL, rtol=0)
    assert np.ptp(ref) > 0.1
    assert os.path.exists(tmp_path / "port" / "supp" / "cell_positions.pkl")
