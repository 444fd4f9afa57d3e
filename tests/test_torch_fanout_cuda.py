"""The fan-out over a process's devices on the card, at ``[cuda:0,
cuda:0]`` (a host with one card runs the chunked, replicated and threaded
code there; with more cards the list would name them): each fanned-out
function against the one-device path.

- tiled and direct segmentation: a chunk's batch differs from the one
  device's, so cuDNN may choose another algorithm; held within the
  card-vs-CPU limit of ``chip_smoke.py`` phase 8 (1e-4);
- ``EncodeProject.encode_batched`` (ResNet18): within 1e-5 of max |z|;
- the fused stage with frames over both entries and ``seg_patch_fused``
  with two site groups (the elementwise stub of
  ``tests/test_torch_fused_cuda.py``): every artifact byte for byte;
- the streaming encode behind it: latents bit for bit, the same
  ``vq_lookup`` launches.

This file imports neither jax nor the JAX package: ``python -m pytest
--noconftest tests/test_torch_fanout_cuda.py`` on the card's machine.
Without a card every test skips.
"""
import os

import numpy as np
import pytest
import torch

from dynamorph_tpu_torch.config.schema import (LatentEncodingConfig,
                                               PatchConfig, PipelineConfig,
                                               SegmentationInferenceConfig)
from dynamorph_tpu_torch.io.pickles import load_pickle
from dynamorph_tpu_torch.models import VQVAEz16
from dynamorph_tpu_torch.models.resnet_simclr import EncodeProject
from dynamorph_tpu_torch.ops import vq
from dynamorph_tpu_torch.pipeline import fused, stream
from dynamorph_tpu_torch.seg.inference import predict_whole_map
from dynamorph_tpu_torch.seg.model import Segment
from test_torch_fused_cuda import CLUSTER, WINDOW, Stub, _bytes, _site

SEG_ATOL = 1e-4


@pytest.fixture
def cards():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: fans out over the card")
    dev = torch.device("cuda", 0)
    return dev, [dev, dev]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["tiled", "direct"])
def test_segmentation_over_two_entries(cards, mode):
    dev, two = cards
    model = Segment(input_shape=(2, 64, 64), device=dev, seed=1)
    frames = np.random.RandomState(0).randint(
        0, 65536, (4, 2, 1, 256, 256)).astype(np.float64)
    out = {}
    for name, devs in (("one", [dev]), ("two", two)):
        np.random.seed(0)
        out[name] = predict_whole_map(frames, model, n_supp=2, mode=mode,
                                      devices=devs)
    assert out["one"].shape == out["two"].shape == (4, 3, 1, 256, 256)
    assert np.abs(out["one"] - out["two"]).max() <= SEG_ATOL


@pytest.mark.cuda
def test_resnet_encode_over_two_entries(cards):
    dev, two = cards
    model = EncodeProject(arch="ResNet18").to(dev)
    data = np.random.RandomState(1).rand(70, 2, 64, 64).astype(np.float32)
    one = model.encode_batched(data, batch_size=32, devices=[dev])
    fan = model.encode_batched(data, batch_size=32, devices=two)
    assert np.abs(one - fan).max() <= 1e-5 * np.abs(one).max()


def _tree(supp):
    out = {}
    for root, _, files in os.walk(supp):
        for name in files:
            path = os.path.join(root, name)
            rel = os.path.relpath(path, supp)
            if name.startswith(("stacks_", "cell_")):
                data = load_pickle(path)
                if name.startswith("stacks_"):
                    data = {os.path.relpath(k, supp): v
                            for k, v in data.items()}
                out[rel] = repr({k: {f: v[f].tobytes() for f in v}
                                 for k, v in data.items()}) \
                    if name.startswith("stacks_") else repr(data)
            else:
                out[rel] = _bytes(path)
    return out


@pytest.mark.cuda
def test_fused_frames_and_site_groups_over_two_entries(cards, tmp_path):
    dev, two = cards
    trees = {}
    for name, devs in (("one", [dev]), ("frames", two)):
        d = tmp_path / name
        d.mkdir()
        site = str(d / "B2-Site_0.npy")
        _site(site, np.uint16)
        fused.process_site_seg_patch_fused(
            site, Stub(dev), str(d / "supp"), seg_channels=[0, 1],
            patch_channels=[0, 1], window_size=WINDOW, devices=devs,
            **CLUSTER)
        trees[name] = _tree(str(d / "supp"))
    assert trees["frames"] == trees["one"]
    config = _config("unused")
    d = tmp_path / "groups"
    d.mkdir()
    for s in ("B2-Site_0", "B2-Site_1"):
        _site(str(d / f"{s}.npy"), np.uint16)
    real = fused.process_site_seg_patch_fused
    try:
        fused.process_site_seg_patch_fused = \
            lambda *a, **k: real(*a, **{**k, **CLUSTER})
        failed = fused.seg_patch_fused(str(d), str(d / "supp"),
                                       ["B2-Site_0", "B2-Site_1"], config,
                                       model=Stub(dev), device=dev,
                                       devices=two, site_parallelism=2)
    finally:
        fused.process_site_seg_patch_fused = real
    assert failed == []
    for s in ("B2-Site_0", "B2-Site_1"):
        assert _tree(str(d / "supp" / "B2-supps" / s)) == trees["one"]


def _config(weights):
    return PipelineConfig(
        segmentation_inference=SegmentationInferenceConfig(
            channels=[0, 1], weights="unused"),
        patch=PatchConfig(channels=[0, 1], window_size=WINDOW),
        latent_encoding=LatentEncodingConfig(
            channels=[0, 1], input_size=WINDOW // 2, weights=weights,
            network="VQ_VAE_z16", num_hiddens=16, num_residual_hiddens=32,
            num_embeddings=64, save_output=False))


@pytest.mark.cuda
def test_stream_over_two_entries(cards, tmp_path):
    dev, two = cards
    torch.manual_seed(0)
    weights = tmp_path / "weights"
    weights.mkdir()
    torch.save(VQVAEz16(num_hiddens=16, num_residual_hiddens=32,
                        num_embeddings=64).state_dict(),
               str(weights / "model.pt"))
    saved = stream.build_seg_model
    stream.build_seg_model = lambda config, device: Stub(device)
    real = fused.process_site_seg_patch_fused
    fused.process_site_seg_patch_fused = \
        lambda *a, **k: real(*a, **{**k, **CLUSTER})
    latents, launches = {}, {}
    try:
        for name, devs, sp in (("one", [dev], 1), ("two", two, 2)):
            d = tmp_path / name
            d.mkdir()
            for s in ("B2-Site_0", "B2-Site_1"):
                _site(str(d / f"{s}.npy"), np.uint16)
            vq.vq_lookup.launches = 0
            stream.seg_patch_stream(str(d), str(d / "supp"),
                                    ["B2-Site_0", "B2-Site_1"],
                                    _config(str(weights)), batch_size=8,
                                    device=dev, devices=devs,
                                    site_parallelism=sp)
            launches[name] = vq.vq_lookup.launches
            latents[name] = [load_pickle(str(d / "weights" / f"B2_{n}.pkl"))
                             for n in ("latent_space",
                                       "latent_space_after")]
    finally:
        stream.build_seg_model = saved
        fused.process_site_seg_patch_fused = real
    assert launches["one"] == launches["two"] > 0
    for a, b in zip(latents["one"], latents["two"]):
        np.testing.assert_array_equal(a, b)
