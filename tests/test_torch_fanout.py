"""The fan-out over one process's devices, port against port on the CPU:
every fanned-out function at ``devices=[cpu] * k`` (k = 1, 2, 3) writes
what one device writes, bit for bit.

- ``core.mesh``: ``device_groups`` (``devices[g::k]``), the batch rounding
  of the JAX package (at least the device count, a multiple of it) and
  the replica cache (one copy a device, made again after the weights
  change).
- ``seg/inference.py``: the tile bucket (8 rounded to the devices, or
  the config's ``segmentation_inference.batch_size`` through
  ``run_segmentation``), equal chunks, padding trimmed; the direct mode's
  frame batch; the whole map, tiled and direct.
- ``EncodeProject.encode_batched``, ``InceptionResNetV2.encode_batched``
  and ``process_vae``'s ResNet branch.
- The fused stage: frames round-robin over the devices, and
  ``seg_patch_fused``'s free-group checkout with more sites than groups
  and a failing site; the streaming encoder's rows in name order when
  frames come from several devices out of order.

On the CPU, oneDNN runs a convolution over a batch of one row with other
arithmetic than over a larger batch (a batch of two or more gives each
row the same bits whatever its size: ``test_batch_of_one_rounds_apart``
pins both). So the bit-equal cases keep every chunk and every one-device
batch at two rows or more, or at one on both sides; the chunks of one
row that the rounding makes (the direct mode's frame batch of 4 at three
devices) are held within 1e-6. The card shows the same for cuDNN's
algorithm choice (``chip_smoke.py`` phase 17).
"""
import os
import threading
import time

import numpy as np
import pytest
import torch

from dynamorph_tpu_torch.cli import run_segmentation
from dynamorph_tpu_torch.core import mesh
from dynamorph_tpu_torch.io.pickles import load_pickle, save_pickle
from dynamorph_tpu_torch.models.inception_resnet_v2 import InceptionResNetV2
from dynamorph_tpu_torch.models.resnet_simclr import EncodeProject
from dynamorph_tpu_torch.pipeline import fused, stream
from dynamorph_tpu_torch.seg import inference
from dynamorph_tpu_torch.seg.model import Segment
from test_fused_seg_patch import _make_site
from test_torch_fused import (SITE, TorchStub, _assert_same_tree, _config,
                              _stub_port, run_port_fused)
from test_torch_train import _few_threads  # noqa: F401

CPU = torch.device("cpu")
KS = [1, 2, 3]


def cpus(k):
    return [CPU] * k


# ------------------------------------------------------------- core.mesh


def test_device_groups_and_batch_rounding():
    devs = [torch.device("cpu", i) for i in range(5)]
    assert mesh.device_groups(devs, 2) == [devs[0::2], devs[1::2]]
    assert mesh.device_groups(devs, 5) == [[d] for d in devs]
    assert [mesh.round_to_devices(8, n) for n in (1, 2, 3, 5, 9)] == \
        [8, 8, 6, 5, 9]
    assert mesh.round_to_devices(4, 3) == 3
    assert mesh.fan_out_devices(None, CPU) == [CPU]
    assert mesh.fan_out_devices(["cpu", "cpu"], CPU) == [CPU, CPU]
    with pytest.raises(ValueError, match="empty"):
        mesh.fan_out_devices([], CPU)


def test_replica_is_made_once_a_device_and_again_after_new_weights():
    model = EncodeProject(arch="ResNet18")
    assert mesh.replica(model, CPU) is model
    other = torch.device("cpu", 1)
    a = mesh.replica(model, other)
    assert a is not model and mesh.replica(model, other) is a
    assert not vars(a).get("_replicas")      # the copies are not copied
    with torch.no_grad():
        model.projection.fc2.weight.mul_(2.0)
    b = mesh.replica(model, other)
    assert b is not a
    assert torch.equal(b.projection.fc2.weight, model.projection.fc2.weight)
    seg = Segment(input_shape=(2, 32, 32), device="cpu")
    r = mesh.replica(seg, other)
    assert r is not seg and r.net is not seg.net and r.device == other


# ----------------------------------------------------------- segmentation


@pytest.fixture(scope="module")
def unet():
    return Segment(input_shape=(2, 32, 32), device="cpu", seed=3)


def _spy(monkeypatch, model):
    """Records the batch size of every forward of ``model``."""
    sizes = []
    real = model.probabilities

    def probabilities(x):
        sizes.append(len(x))
        return real(x)
    monkeypatch.setattr(model, "probabilities", probabilities)
    return sizes


@pytest.mark.parametrize("k", KS)
def test_predict_tiles_over_devices(unet, monkeypatch, k):
    """9 tiles: one batch of 9 on one device; over 2 devices padded to 16
    (bucket 8), over 3 to 12 (bucket 6), in equal chunks; the padding is
    trimmed and every tile's probabilities are one device's."""
    tiles = np.random.RandomState(1).randint(0, 65536, (9, 2, 32, 32)) \
        .astype(np.uint16)
    ref = inference._predict_tiles(unet, tiles)
    sizes = _spy(monkeypatch, unet)
    out = inference._predict_tiles(unet, tiles, cpus(k))
    assert sizes == {1: [9], 2: [8, 8], 3: [4, 4, 4]}[k]
    assert out.shape == (9, 3, 1, 32, 32)
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("k", KS)
def test_direct_mode_over_devices(unet, monkeypatch, k):
    frames = np.random.RandomState(2).randint(0, 65536, (6, 2, 1, 64, 64)) \
        .astype(np.float64)
    ref = inference.predict_whole_map_direct(frames, unet, frame_batch=6)
    sizes = _spy(monkeypatch, unet)
    out = inference.predict_whole_map_direct(frames, unet, frame_batch=6,
                                             devices=cpus(k))
    assert sizes == {1: [6], 2: [3, 3], 3: [2, 2, 2]}[k]
    np.testing.assert_array_equal(out, ref)


def test_direct_frame_batch_rounds_to_devices(unet, monkeypatch):
    """frame_batch 4 over 3 devices becomes 3 (:113-123); 5 frames go in
    batches of 3 and of 2 zero-padded to 3, a frame a chunk. Chunks of
    one row round apart from the one-device batch of 4 (module
    docstring): within 1e-6."""
    frames = np.random.RandomState(4).randint(0, 65536, (5, 2, 1, 32, 32)) \
        .astype(np.float64)
    ref = inference.predict_whole_map_direct(frames, unet)
    sizes = _spy(monkeypatch, unet)
    out = inference.predict_whole_map_direct(frames, unet, devices=cpus(3))
    assert sizes == [1] * 6
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("mode,k", [("tiled", 1), ("tiled", 2),
                                    ("tiled", 3), ("direct", 1),
                                    ("direct", 2)])
def test_whole_map_over_devices(unet, mode, k):
    """The tiled ensemble on two 96 x 96 frames (9 tiles, then 4 a
    supplementary pass, the offsets drawn from one seed) and the direct
    mode on four 64 x 64 frames (a batch of 4, two chunks of 2 over two
    devices; three devices make chunks of one row, held above)."""
    shape = (2, 2, 1, 96, 96) if mode == "tiled" else (4, 2, 1, 64, 64)
    frames = np.random.RandomState(5).randint(0, 65536, shape) \
        .astype(np.float64)
    np.random.seed(0)
    ref = inference.predict_whole_map(frames, unet, n_supp=2, mode=mode)
    np.random.seed(0)
    out = inference.predict_whole_map(frames, unet, n_supp=2, mode=mode,
                                      devices=cpus(k))
    np.testing.assert_array_equal(out, ref)


def _jax_bucket_pad(n, batch_bucket, n_dev):
    """dynamorph_tpu/seg/inference.py:33-39: the bucket raised to the
    device count and rounded down to a multiple of it, then ``n`` padded
    to a multiple of the bucket."""
    if n_dev > 1:
        batch_bucket = max(batch_bucket, n_dev)
        batch_bucket -= batch_bucket % n_dev
    return ((n + batch_bucket - 1) // batch_bucket) * batch_bucket


@pytest.mark.parametrize("batch_size", [16, None])
def test_config_batch_size_is_the_tile_bucket(unet, tmp_path, monkeypatch,
                                              batch_size):
    """``run_segmentation -m segmentation`` with
    ``segmentation_inference.batch_size: 16`` over three devices pads each
    pass as the JAX package does (25 base tiles and 16 offset tiles of a
    160 x 160 frame: both to 30, bucket 15); without the key the bucket is
    8 (6 over three devices: 30 and 18). The probabilities are one
    device's."""
    stack = np.random.RandomState(8).randint(0, 65536, (1, 2, 1, 160, 160)) \
        .astype(np.float64)
    raw = tmp_path / "raw"
    raw.mkdir()
    np.save(raw / "B2-Site_0.npy", stack)
    unet.save(str(tmp_path / "w"))
    yml = tmp_path / "cfg.yml"
    yml.write_text(
        "segmentation_inference:\n"
        f"  raw_dirs: ['{raw}']\n  supp_dirs: ['{tmp_path}']\n"
        f"  weights: '{tmp_path / 'w'}'\n  channels: [0, 1]\n"
        "  window_size: 32\n  num_pred_rnd: 1\n"
        + (f"  batch_size: {batch_size}\n" if batch_size else ""))
    padded = []
    fanned = inference._predict_fanned_out

    def spy(model, batch, devices):
        padded.append(len(batch))
        return fanned(model, batch, devices)
    monkeypatch.setattr(inference, "_predict_fanned_out", spy)
    monkeypatch.setattr(inference, "fan_out_devices",
                        lambda devices, home: cpus(3))
    np.random.seed(9)
    run_segmentation.main(["-m", "segmentation", "-c", str(yml),
                           "--device", "cpu"])
    bucket = batch_size or inference.TILE_BUCKET
    assert padded == [_jax_bucket_pad(25, bucket, 3),
                      _jax_bucket_pad(16, bucket, 3)] == \
        {16: [30, 30], None: [30, 18]}[batch_size]
    monkeypatch.undo()
    np.random.seed(9)
    want = inference.predict_whole_map(stack, unet, n_supp=1)
    np.testing.assert_array_equal(
        np.load(raw / "B2-Site_0_NNProbabilities.npy"), want)


def test_batch_of_one_rounds_apart(unet):
    """The CPU fact the bit-equal cases respect: a batch of two or more
    gives each row the same bits at any size, a batch of one not quite."""
    x = torch.from_numpy(np.random.RandomState(6).rand(4, 2, 32, 32)
                         .astype(np.float32))
    full = unet.probabilities(x)
    assert torch.equal(torch.cat([unet.probabilities(x[:2]),
                                  unet.probabilities(x[2:])]), full)
    ones = torch.cat([unet.probabilities(x[i:i + 1]) for i in range(4)])
    assert (ones - full).abs().max() <= 1e-6


# ---------------------------------------------------------------- encodes


@pytest.fixture(scope="module")
def resnet():
    return EncodeProject(arch="ResNet18")


@pytest.mark.parametrize("k", KS)
def test_resnet_encode_over_devices(resnet, k):
    """13 patches at batch 6: batches of 6 (chunks of 3 or 2) and a last
    row alone on every device count."""
    data = np.random.RandomState(7).rand(13, 2, 32, 32).astype(np.float32)
    for out in ("z", "h"):
        ref = resnet.encode_batched(data, out=out, batch_size=6)
        np.testing.assert_array_equal(
            resnet.encode_batched(data, out=out, batch_size=6,
                                  devices=cpus(k)), ref)


@pytest.mark.parametrize("k", KS)
def test_inception_encode_over_devices(k):
    model = _inception()
    data = np.random.RandomState(8).rand(7, 3, 75, 75).astype(np.float32)
    ref = model.encode_batched(data, batch_size=6)
    assert ref.shape == (7, 1536)
    np.testing.assert_array_equal(
        model.encode_batched(data, batch_size=6, devices=cpus(k)), ref)


_INCEPTION = []


def _inception():
    if not _INCEPTION:
        _INCEPTION.append(InceptionResNetV2(seed=0))
    return _INCEPTION[0]


def _resnet_well(root, resnet):
    from dynamorph_tpu_torch.config.schema import PipelineConfig

    raw = root / "raw"
    raw.mkdir()
    data = np.random.RandomState(9).rand(13, 2, 1, 32, 32) * 1000
    save_pickle([f"C5-Site_0/{i}_0.h5" for i in range(13)],
                str(raw / "C5_file_paths.pkl"))
    save_pickle(data, str(raw / "C5_static_patches.pkl"))
    weights = root / "ResNet18"
    weights.mkdir()
    torch.save(resnet.state_dict(), str(weights / "model.pt"))
    config = PipelineConfig()
    config.latent_encoding.network = "ResNet18"
    config.latent_encoding.weights = str(weights)
    return str(raw), config


@pytest.mark.parametrize("k", KS)
def test_process_resnet_branch_over_devices(resnet, tmp_path, k):
    from dynamorph_tpu_torch.pipeline.patch_vae import process_vae

    raw, config = _resnet_well(tmp_path, resnet)
    latents = os.path.join(raw, "ResNet18", "C5_latent_space.pkl")
    process_vae(raw, raw, ["C5-Site_0"], config, batch_size=6, device="cpu")
    ref = load_pickle(latents)
    os.remove(latents)
    process_vae(raw, raw, ["C5-Site_0"], config, batch_size=6, device="cpu",
                devices=cpus(k))
    out = load_pickle(latents)
    assert out.shape == (13, 128)
    np.testing.assert_array_equal(out, ref)


# --------------------------------------------------------- the fused stage


@pytest.fixture(scope="module")
def one_device_site(tmp_path_factory):
    root = tmp_path_factory.mktemp("one_device")
    site = _make_site(root, SITE)
    run_port_fused(site, str(root / "supp"))
    return str(root), str(root / "supp")


@pytest.mark.parametrize("k,lookahead", [(1, True), (2, True), (3, True),
                                         (3, False)])
def test_fused_site_over_devices(one_device_site, tmp_path, k, lookahead):
    """Frame t on devices[t % k] (each frame's device recorded by the
    frame hook); every artifact is one device's. Without lookahead the
    stage keeps the first device."""
    site = _make_site(tmp_path, SITE)
    devs = [torch.device("cpu", i) for i in range(k)]
    seen = []
    run_port_fused(site, str(tmp_path / "supp"), devices=devs,
                   lookahead=lookahead,
                   frame_hook=lambda t, out, kept, d: seen.append((t, d)))
    want = [(t, devs[t % k] if lookahead else devs[0]) for t in range(3)]
    assert seen == want
    _assert_same_tree({"one": one_device_site,
                       "fan": (str(tmp_path), str(tmp_path / "supp"))},
                      "fan", "one")


def test_seg_patch_fused_checks_out_free_groups(one_device_site, tmp_path,
                                               monkeypatch):
    """Four sites over four devices in two groups ([0, 2] and [1, 3]): at
    most two sites run at once, never two on one group, each on a whole
    group; a site whose stack is not 5-D fails alone; the others write
    one device's artifacts."""
    _stub_port(monkeypatch)
    names = [f"C5-Site_{i}" for i in range(4)]
    for name in names[:3]:
        _make_site(tmp_path, name)
    np.save(tmp_path / f"{names[3]}.npy", np.zeros((2, 64, 64), np.uint16))
    devs = [torch.device("cpu", i) for i in range(4)]
    groups = mesh.device_groups(devs, 2)
    running, log, lock = [], [], threading.Lock()
    real = fused.process_site_seg_patch_fused

    def spy(site_path, *a, devices=None, **kw):
        with lock:
            running.append(devices)
            log.append((len(running), [d for g in running for d in g]))
        time.sleep(0.05)
        try:
            return real(site_path, *a, devices=devices, **kw)
        finally:
            with lock:
                running.remove(devices)

    monkeypatch.setattr(fused, "process_site_seg_patch_fused", spy)
    failed = fused.seg_patch_fused(str(tmp_path), str(tmp_path / "supp"),
                                   names, _config(), model=TorchStub(),
                                   device="cpu", devices=devs,
                                   site_parallelism=2)
    assert [s for s, _ in failed] == [names[3]]
    assert len(log) == 4
    assert max(n for n, _ in log) == 2
    for _, busy in log:
        assert len(busy) == len(set(busy))      # no device twice at once
    assert all(g in groups for g in [g for _, busy in log for g in
                                     [busy[i:i + 2]
                                      for i in range(0, len(busy), 2)]])
    for name in names[:3]:
        _assert_same_tree(
            {"one": one_device_site,
             "fan": (str(tmp_path), str(tmp_path / "supp" / "C5-supps" /
                                        name))}, "fan", "one")


def test_seg_patch_fused_clamps_site_parallelism(tmp_path, monkeypatch):
    """The default is min(devices, sites); more than either is clamped;
    one group runs the sites one after another on every device."""
    seen = []
    monkeypatch.setattr(fused, "process_site_seg_patch_fused",
                        lambda *a, devices=None, **k: seen.append(devices))
    names = [f"C5-Site_{i}" for i in range(3)]
    for name in names:
        np.save(tmp_path / f"{name}.npy", np.zeros(1))
    devs = [torch.device("cpu", i) for i in range(2)]
    for sp, want in ((None, {(d,) for d in devs}), (8, {(d,) for d in devs}),
                     (1, {tuple(devs)})):
        seen.clear()
        fused.seg_patch_fused(str(tmp_path), str(tmp_path / "supp"), names,
                              _config(), model=TorchStub(), device="cpu",
                              devices=devs, site_parallelism=sp)
        assert len(seen) == 3 and {tuple(g) for g in seen} <= want


# ------------------------------------------------------ the stream encoder


def test_stream_rows_in_name_order_from_devices_out_of_order(monkeypatch):
    """Frames of two devices arrive out of order; each device gathers and
    encodes its own rows (batch 4: dispatches per device), and ``finish``
    returns names, latents and static patches in sorted-name order, each
    row beside its name."""
    calls = []

    def fake_encode(model, x, batch_size, normalize=None):
        calls.append(len(x))
        flat = x.reshape(len(x), -1)
        return flat[:, :1].clone(), -flat[:, :1]

    monkeypatch.setattr(stream, "encode_batch", fake_encode)
    enc = stream.StreamingWellEncoder(None, [0, 1], window_size=4,
                                      input_size=2, batch_size=4)
    devs = [torch.device("cpu", 0), torch.device("cpu", 1)]
    order = [5, 0, 3, 1, 4, 2, 7, 6]
    for t in order:
        cells = [(c, (2, 2)) for c in range(t % 3 + 1)]
        mat = torch.stack([torch.full((2, 4, 4), 100.0 * t + c)
                           for c, _ in cells])
        enc.add_frame("s", t, {"mat": mat}, cells, devs[t % 2])
    names, z_b, z_a, static = enc.finish()
    assert names == sorted(names) and len(names) == 15
    want = np.array([100 * int(t) + int(c) for t, c in (
        os.path.basename(n)[:-3].split("_") for n in names)])
    np.testing.assert_array_equal(z_b[:, 0], want)
    np.testing.assert_array_equal(z_a[:, 0], -want)
    np.testing.assert_array_equal(static[:, 0, 0, 0, 0], want)
    # device 0 had frames 0, 2, 4, 6 (1 + 3 + 2 + 1 rows): a full batch
    # and a remainder of 3; device 1 frames 1, 3, 5, 7 (2 + 1 + 3 + 2):
    # two full batches
    assert enc.dispatches == {devs[0]: 2, devs[1]: 2}
    assert sorted(calls) == [3, 4, 4, 4]
