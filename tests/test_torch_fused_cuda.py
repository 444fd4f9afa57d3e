"""The fused stage and the streaming encode on the card against the port's
CPU path: ``pack_mask_bits`` and ``scatter_label_map`` on a 2048 x 2048
frame, the fused stage on a small stub site (every artifact bit for bit:
the stub is elementwise, the extraction exact), and the streamed latents
at phase 4's limits of ``chip_smoke.py`` (z_before within 1e-4, z_after on
the same codes but at near-ties that the latents' own difference can
move).

This file imports neither jax nor the JAX package, so it also runs on a GPU
host without them: ``python -m pytest --noconftest
tests/test_torch_fused_cuda.py``. Without a card every test skips.
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
from dynamorph_tpu_torch.ops.patch import pack_mask_bits, scatter_label_map
from dynamorph_tpu_torch.pipeline import fused, stream

LATENT_ATOL = 1e-4
SIZE = 256
T = 3
WINDOW = 64
CENTERS = np.array([[40, 50], [60, 190], [150, 120], [210, 40], [200, 210]])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: compares the card with the CPU")
    return torch.device("cuda")


class Stub:
    """Elementwise stand-in for the U-Net: cell probability from channel
    0, exact in float32 on any device."""

    n_classes = 3

    def __init__(self, device):
        self.device = torch.device(device)

    def probabilities(self, x):
        on = (x[:, 0] > 0.5).to(torch.float32)
        p1 = 0.875 * on
        p2 = torch.full_like(p1, 0.0625)
        return torch.stack([(1.0 - p2) - p1, p1, p2], 1)[:, :, None]


def _site(path, dtype):
    """(T, 2, 1, 256, 256) site of 5 drifting disk cells of radius 18 on
    uint16-range noise, as ``dtype``."""
    r = np.random.RandomState(1)
    yy, xx = np.mgrid[:SIZE, :SIZE]
    stack = r.randint(9000, 15000, (T, 2, 1, SIZE, SIZE)).astype(np.float64)
    for t in range(T):
        for cy, cx in CENTERS + 2 * t:
            cell = (yy - cy) ** 2 + (xx - cx) ** 2 < 18 ** 2
            stack[t, 0, 0][cell] = r.randint(50000, 60000, cell.sum())
            stack[t, 1, 0][cell] += 20000
    np.save(path, stack.astype(dtype))


CLUSTER = dict(ct_thr=(200, 4000), dbscan_thr=(5, 20))


@pytest.mark.cuda
def test_pack_and_scatter_card_vs_cpu(cuda):
    r = np.random.RandomState(0)
    mask = torch.from_numpy(r.rand(2048, 2048) < 0.3)
    np.testing.assert_array_equal(pack_mask_bits(mask.to(cuda)).cpu(),
                                  pack_mask_bits(mask))
    flat = r.choice(2048 * 2048, 200000, replace=False)
    coords = torch.from_numpy(np.stack(np.unravel_index(
        flat, (2048, 2048)), 1).astype(np.int16))
    labels = torch.from_numpy(r.randint(0, 30000, 200000).astype(np.int16))
    card = scatter_label_map(coords.to(cuda), labels.to(cuda), (2048, 2048))
    cpu = scatter_label_map(coords, labels, (2048, 2048))
    np.testing.assert_array_equal(card.cpu(), cpu)
    assert (cpu >= 0).sum() == 200000


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.uint16, np.float64])
def test_fused_stage_card_vs_cpu(cuda, tmp_path, dtype):
    """The fused stage on the card writes the CPU's artifacts bit for bit:
    the pickles, every stack, the probabilities and the PNGs (a uint16
    stack uploads as uint16, a float64 one as float32)."""
    out = {}
    for dev in ("cpu", "cuda"):
        d = tmp_path / dev
        d.mkdir()
        site = str(d / "B2-Site_0.npy")
        _site(site, dtype)
        moved = fused.process_site_seg_patch_fused(
            site, Stub(dev), str(d / "supp"), seg_channels=[0, 1],
            patch_channels=[0, 1], window_size=WINDOW, **CLUSTER)
        out[dev] = (d, moved)
    assert out["cpu"][1] == out["cuda"][1]
    a, b = out["cpu"][0], out["cuda"][0]
    cp = load_pickle(str(a / "supp" / "cell_positions.pkl"))
    assert [len(cp[t]) for t in range(T)] == [len(CENTERS)] * T
    for name in sorted(os.listdir(a / "supp")):
        if name.startswith("stacks_"):
            x, y = (load_pickle(str(d / "supp" / name)) for d in (a, b))
            x = {os.path.basename(k): v for k, v in x.items()}
            y = {os.path.basename(k): v for k, v in y.items()}
            assert list(x) == list(y)
            for k in x:
                for f in ("mat", "masked_mat"):
                    np.testing.assert_array_equal(x[k][f], y[k][f])
        elif name.startswith("cell_"):
            assert repr(load_pickle(str(a / "supp" / name))) == \
                repr(load_pickle(str(b / "supp" / name)))
        else:
            assert _bytes(a / "supp" / name) == _bytes(b / "supp" / name), \
                name
    for name in ("B2-Site_0_NNProbabilities.npy", "B2-Site_0.png",
                 "B2-Site_0_NNpred.png"):
        assert _bytes(a / name) == _bytes(b / name), name


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _codes(z_a, codebook):
    rows = torch.from_numpy(z_a).reshape(len(z_a), 16, -1).permute(0, 2, 1) \
        .reshape(-1, 16).double()
    d = torch.cdist(rows, codebook.double(),
                    compute_mode="donot_use_mm_for_euclid_dist")
    val, idx = torch.min(d, 1)
    assert float(val.max()) == 0.0
    return idx


@pytest.mark.cuda
@pytest.mark.parametrize("batch_size,dispatches", [(512, 1), (8, 2)])
def test_streamed_latents_card_vs_cpu(cuda, tmp_path, monkeypatch,
                                      batch_size, dispatches):
    """seg_patch_stream on the card against the CPU at the same batch
    size, VQ_VAE_z16 at its published widths (input 32 here, the window 64
    halved): the same file paths and static patches bit for bit, z_before
    within 1e-4, z_after on the same codes except where a code's float64
    distance gap is within what the latents' difference can move. The
    encode launches vq_lookup once a dispatch: one for the 15 patches at
    batch 512; at batch 8, 8 rows (carried over from the second frame)
    and then 7."""
    from dynamorph_tpu_torch.ops import vq

    real_site = fused.process_site_seg_patch_fused
    monkeypatch.setattr(fused, "process_site_seg_patch_fused",
                        lambda *a, **k: real_site(*a, **{**k, **CLUSTER}))

    torch.manual_seed(0)
    model = VQVAEz16(num_inputs=2)
    weights = tmp_path / "weights"
    weights.mkdir()
    torch.save(model.state_dict(), str(weights / "model.pt"))
    config = PipelineConfig(
        segmentation_inference=SegmentationInferenceConfig(
            channels=[0, 1], weights="unused"),
        patch=PatchConfig(channels=[0, 1], window_size=WINDOW),
        latent_encoding=LatentEncodingConfig(
            channels=[0, 1], input_size=32, weights=str(weights),
            save_output=False))
    out = {}
    for dev in ("cpu", "cuda"):
        monkeypatch.setattr(stream, "build_seg_model",
                            lambda config, device, _d=dev: Stub(_d))
        raw = tmp_path / dev
        raw.mkdir()
        _site(str(raw / "B2-Site_0.npy"), np.uint16)
        vq.vq_lookup.launches = 0
        stream.seg_patch_stream(str(raw), str(raw / "supp"), ["B2-Site_0"],
                                config, batch_size=batch_size, device=dev)
        out[dev] = {n: load_pickle(str(raw / n)) for n in (
            "B2_file_paths.pkl", "B2_static_patches.pkl",
            "weights/B2_latent_space.pkl",
            "weights/B2_latent_space_after.pkl")}
        out[dev]["launches"] = vq.vq_lookup.launches
        out[dev]["B2_file_paths.pkl"] = [
            os.path.relpath(f, raw / "supp")
            for f in out[dev]["B2_file_paths.pkl"]]
    cpu, card = out["cpu"], out["cuda"]
    assert (cpu["launches"], card["launches"]) == (0, dispatches)
    assert cpu["B2_file_paths.pkl"] == card["B2_file_paths.pkl"]
    assert len(cpu["B2_file_paths.pkl"]) == len(CENTERS) * T
    np.testing.assert_array_equal(card["B2_static_patches.pkl"],
                                  cpu["B2_static_patches.pkl"])
    zb_c, zb_g = cpu["weights/B2_latent_space.pkl"], \
        card["weights/B2_latent_space.pkl"]
    assert np.abs(zb_c - zb_g).max() <= LATENT_ATOL
    cb = model.vq.w.weight.detach()
    za_c, za_g = cpu["weights/B2_latent_space_after.pkl"], \
        card["weights/B2_latent_space_after.pkl"]
    ic, ig = _codes(za_c, cb), _codes(za_g, cb)
    flips = torch.nonzero(ic != ig).flatten()
    if len(flips):
        def rows(z):
            return torch.from_numpy(z).reshape(len(z), 16, -1) \
                .permute(0, 2, 1).reshape(-1, 16).double()[flips]

        zc, zg = rows(zb_c), rows(zb_g)
        ea, eb = cb.double()[ic[flips]], cb.double()[ig[flips]]
        gap = ((zc - eb) ** 2).sum(1) - ((zc - ea) ** 2).sum(1)
        room = 2 * torch.norm(zc - zg, dim=1) * torch.norm(ea - eb, dim=1) \
            + 1e-6 * ((zc - ea) ** 2).sum(1)
        assert bool((gap.abs() <= room).all())
