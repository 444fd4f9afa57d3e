"""The port's fused segmentation -> instance -> patch stage
(``pipeline/fused.py``, ``ops/patch.py::pack_mask_bits`` and
``scatter_label_map``) against the JAX package and against the port's own
staged path, on the CPU.

The site is the JAX tests' (``tests/test_fused_seg_patch.py``): 3 frames of
2 x 64 x 64 uint16 with 3 moving disk cells, clustered with its small-frame
``CLUSTER`` parameters, window 32. The model is the JAX tests' elementwise
stub (piecewise linear, no transcendentals) and its torch twin, so both
packages and both paths see the same float32 probabilities and every
artifact must be equal: the pickles, the patch stacks, the probabilities
and the decoded PNGs. (The port's instance maps are its own label image,
``track/clustering.py``; they are held against the port's staged ones.)
The fused stage with a tiny real U-Net is held against the JAX package's
in ``tests/test_torch_segmentation.py``, on that file's model.

The JAX stage runs once per module for each case, its DBSCAN on sklearn
(its own fallback: no native build of the JAX package starts here) and its
instance-map figure stubbed.
"""
import functools
import os

import cv2
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dynamorph_tpu.ops import patch as jax_ops
from dynamorph_tpu.pipeline import fused as jax_fused
from dynamorph_tpu_torch.core.constants import CHANNEL_MAX
from dynamorph_tpu_torch.io.pickles import load_pickle, save_pickle
from dynamorph_tpu_torch.ops.patch import (labels_to_map, pack_mask_bits,
                                           scatter_label_map)
from dynamorph_tpu_torch.pipeline import fused
from dynamorph_tpu_torch.pipeline.patch import process_site_extract_patches
from dynamorph_tpu_torch.seg.inference import predict_whole_map
from dynamorph_tpu_torch.track import clustering
from test_fused_seg_patch import CLUSTER, StubSeg, _make_site
from test_torch_patch_track import _assert_same
from test_torch_train import _few_threads  # noqa: F401

SITE = "C5-Site_0"
WINDOW = 32
CHANNELS = [0, 1]
T = 3
# the sites of the site-group run (the same stack under two names)
GROUP_SITES = [SITE, "C5-Site_1"]
# with a 40 px window, only the cell at (20, 20) of the last frame keeps
# its window inside the 64 x 64 frame
SKIP_WINDOW = 40


class TorchStub:
    """The torch twin of the JAX tests' ``StubSeg``: cell probability
    rising with channel 0, the same float32 values. XLA's simplifier folds
    the constant of ``1 - p1 - p2`` first, ``(1 - p2) - p1``, which rounds
    otherwise at p1 = 0.9, so the twin computes it that way. ``predict_raw``
    serves the staged direct mode (seg/inference.py)."""

    n_classes = 3

    def __init__(self, device="cpu"):
        self.device = torch.device(device)

    def probabilities(self, x):
        blob = torch.clamp((x[:, 0] - 0.5) * 10.0, 0.0, 1.0)
        p1 = 0.9 * blob
        p2 = torch.full_like(p1, 0.05)
        p0 = (1.0 - p2) - p1
        return torch.stack([p0, p1, p2], 1)[:, :, None]

    def predict_raw(self, x):
        t = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
        return self.probabilities(t.to(torch.float32) / CHANNEL_MAX) \
            .cpu().numpy()


def run_port_fused(site_path, supp, model=None, **kw):
    """The port's fused stage on one site (CPU), the JAX tests' arguments."""
    return fused.process_site_seg_patch_fused(
        site_path, model or TorchStub(), supp, seg_channels=CHANNELS,
        patch_channels=CHANNELS, **{"window_size": WINDOW, **CLUSTER, **kw})


def _run_jax_fused(site_path, supp, monkeypatch, model=None, **kw):
    monkeypatch.setattr("dynamorph_tpu.native.dbscan._load", lambda: None)
    maps = []
    monkeypatch.setattr(jax_fused, "save_instance_map",
                        lambda *a: maps.append(os.path.basename(a[-1])))
    jax_fused.process_site_seg_patch_fused(
        site_path, model or StubSeg(), supp, seg_channels=CHANNELS,
        patch_channels=CHANNELS, **{"window_size": WINDOW, **CLUSTER, **kw})
    return maps


def _run_port_staged(site_path, supp, mp):
    """segmentation (direct mode, the stub) -> instance_segmentation (with
    CLUSTER) -> extract_patches, the port's staged functions."""
    predict_whole_map(site_path, TorchStub(), use_channels=CHANNELS,
                      mode="direct")
    prob = os.path.splitext(site_path)[0] + "_NNProbabilities.npy"
    mp.setattr(clustering, "instance_clustering",
               functools.partial(clustering.instance_clustering, **CLUSTER))
    clustering.process_site_instance_segmentation(site_path, prob, supp)
    process_site_extract_patches(site_path, prob, supp, window_size=WINDOW,
                                 channels=CHANNELS, reload=False,
                                 device="cpu")


class _JaxStubSegment(StubSeg):
    """``StubSeg`` built and loaded as the JAX stages build a Segment."""

    def __init__(self, **kw):
        pass

    def load(self, path):
        pass


def _stub_jax(mp):
    """The JAX package's stages on the stub, sklearn's DBSCAN and no
    instance-map figure; they pass no CLUSTER, so the site function gets
    it."""
    import dynamorph_tpu.seg.model as jax_seg_model

    mp.setattr(jax_seg_model, "Segment", _JaxStubSegment)
    mp.setattr("dynamorph_tpu.native.dbscan._load", lambda: None)
    mp.setattr(jax_fused, "save_instance_map", lambda *a: None)
    real = jax_fused.process_site_seg_patch_fused
    mp.setattr(jax_fused, "process_site_seg_patch_fused",
               lambda *a, **kw: real(*a, **{**kw, **CLUSTER}))


def _stub_port(mp):
    """The port's stages on the torch stub, with CLUSTER."""
    from dynamorph_tpu_torch.pipeline import stream

    for module in (fused, stream):
        mp.setattr(module, "build_seg_model",
                   lambda config, device: TorchStub())
    real = fused.process_site_seg_patch_fused
    mp.setattr(fused, "process_site_seg_patch_fused",
               lambda *a, **kw: real(*a, **{**kw, **CLUSTER}))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The stub site through: the JAX fused stage, the port's fused stage
    (default schedule of 3 cluster workers, one and two workers,
    skip_boundary) and the port's staged path, each on its own copy.
    Returns {name: (raw dir, supp dir)} and the JAX run's instance-map
    names."""
    root = tmp_path_factory.mktemp("fused")
    dirs = {}
    for name in ("jax", "port", "staged", "one_worker", "two_workers",
                 "jax_skip", "port_skip", "port_fanout"):
        raw = root / name
        _make_site(raw, SITE)
        dirs[name] = (str(raw), str(raw / "supp"))
    site = {k: os.path.join(raw, f"{SITE}.npy") for k, (raw, _) in
            dirs.items()}
    mp = pytest.MonkeyPatch()
    try:
        dirs["jax_maps"] = _run_jax_fused(site["jax"], dirs["jax"][1], mp)
        _run_jax_fused(site["jax_skip"], dirs["jax_skip"][1], mp,
                       window_size=SKIP_WINDOW, skip_boundary=True)
    finally:
        mp.undo()
    dirs["moved"] = run_port_fused(site["port"], dirs["port"][1],
                                   cluster_workers=3)
    for name, workers in (("one_worker", 1), ("two_workers", 2)):
        run_port_fused(site[name], dirs[name][1], cluster_workers=workers)
    run_port_fused(site["port_skip"], dirs["port_skip"][1],
                   window_size=SKIP_WINDOW, skip_boundary=True)
    run_port_fused(site["port_fanout"], dirs["port_fanout"][1],
                   devices=[torch.device("cpu")] * 3)
    mp = pytest.MonkeyPatch()
    try:
        _run_port_staged(site["staged"], dirs["staged"][1], mp)
        # two sites, three devices, two site groups
        _stub_port(mp)
        raw = root / "site_groups"
        for name in GROUP_SITES:
            _make_site(raw, name)
        fused.seg_patch_fused(str(raw), str(raw / "supp"), GROUP_SITES,
                              _config(), model=TorchStub(), device="cpu",
                              devices=[torch.device("cpu")] * 3,
                              site_parallelism=2)
        for name in GROUP_SITES:
            dirs[name] = (str(raw), str(raw / "supp" / "C5-supps" / name))
    finally:
        mp.undo()
    return dirs


def _stacks(dirs, which):
    """{t: {patch name relative to supp: {"mat", "masked_mat"}}}"""
    supp = dirs[which][1]
    return {t: {os.path.relpath(k, supp): v for k, v in
                load_pickle(os.path.join(supp, f"stacks_{t}.pkl")).items()}
            for t in range(T)}


def _png(path):
    return cv2.imread(path, cv2.IMREAD_UNCHANGED)


def _site_files(dirs, which, suffix):
    return os.path.join(dirs[which][0], SITE + suffix)


# --------------------------------------------------------------- the ops


@pytest.mark.parametrize("shape", [(64, 64), (7, 24), (33, 8)])
def test_pack_mask_bits_matches_jax(shape):
    """The packed bytes equal the JAX package's, and np.unpackbits
    (little) gives the mask back."""
    mask = np.random.RandomState(sum(shape)).rand(*shape) < 0.4
    ours = pack_mask_bits(torch.from_numpy(mask)).numpy()
    ref = np.asarray(jax_ops.pack_mask_bits(jnp.asarray(mask)))
    assert ours.dtype == np.uint8 and ours.shape == (shape[0], shape[1] // 8)
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(
        np.unpackbits(ours, axis=1, bitorder="little").astype(bool), mask)


def test_pack_mask_bits_refuses_ragged_width():
    with pytest.raises(ValueError, match="multiple of 8"):
        pack_mask_bits(torch.zeros(4, 12, dtype=torch.bool))


def test_scatter_label_map_matches_jax():
    """Listed pixels take their labels and the rest stays -1, as the JAX
    package's scatter and ``labels_to_map`` give them; padded rows past
    the map are dropped and negative ones count from the end, as JAX's
    ``mode="drop"`` does."""
    r = np.random.RandomState(3)
    shape = (40, 56)
    flat = r.choice(shape[0] * shape[1], 300, replace=False)
    coords = np.stack(np.unravel_index(flat, shape), 1).astype(np.int32)
    labels = r.randint(0, 9, 300).astype(np.int32)
    pads = np.array([[40, 0], [0, 56], [40, 56], [-1, 3], [2, -5]],
                    np.int32)
    all_coords = np.concatenate([coords, pads])
    all_labels = np.concatenate([labels, [7, 7, 7, 11, 12]]).astype(
        np.int32)
    ours = scatter_label_map(torch.from_numpy(all_coords),
                             torch.from_numpy(all_labels), shape).numpy()
    ref = np.asarray(jax_ops.scatter_label_map(
        jnp.asarray(all_coords), jnp.asarray(all_labels), shape))
    assert ours.dtype == np.int32
    np.testing.assert_array_equal(ours, ref)
    assert ours[39, 3] == 11 and ours[2, 51] == 12
    # the valid rows alone, uploaded as int16: labels_to_map's map
    np.testing.assert_array_equal(
        scatter_label_map(torch.from_numpy(coords.astype(np.int16)),
                          torch.from_numpy(labels.astype(np.int16)),
                          shape).numpy(),
        labels_to_map(shape, coords, labels))


# ------------------------------------------------- the stage vs the JAX one


@pytest.mark.parametrize("name", ["cell_positions.pkl",
                                  "cell_pixel_assignments.pkl"])
def test_fused_pickles_match_jax(runs, name):
    ours = load_pickle(os.path.join(runs["port"][1], name))
    ref = load_pickle(os.path.join(runs["jax"][1], name))
    _assert_same(ours, ref)
    if name == "cell_positions.pkl":
        assert sorted(ours) == list(range(T))
        assert all(len(ours[t]) == 3 for t in ours)


def test_fused_stacks_match_jax(runs):
    ours, ref = _stacks(runs, "port"), _stacks(runs, "jax")
    for t in range(T):
        assert len(ours[t]) == 3
        _assert_same(ours[t], ref[t], f"stacks_{t}")


def test_fused_probabilities_and_previews_match_jax(runs):
    """``_NNProbabilities.npy`` (float32, the fused stage's) bit for bit;
    the raw-frame and prediction PNGs decoded pixel for pixel; an
    instance map for every frame that the JAX stage drew one for."""
    ours = np.load(_site_files(runs, "port", "_NNProbabilities.npy"))
    ref = np.load(_site_files(runs, "jax", "_NNProbabilities.npy"))
    assert ours.dtype == ref.dtype == np.float32
    assert ours.shape == (T, 3, 1, 64, 64)
    np.testing.assert_array_equal(ours, ref)
    for suffix in (".png", "_NNpred.png"):
        np.testing.assert_array_equal(_png(_site_files(runs, "port", suffix)),
                                      _png(_site_files(runs, "jax", suffix)))
    maps = sorted(f for f in os.listdir(runs["port"][1])
                  if f.startswith("segmentation_"))
    assert maps == sorted(runs["jax_maps"]) == \
        [f"segmentation_{t}.png" for t in range(T)]


@pytest.mark.parametrize("run", ["port_fanout"] + GROUP_SITES)
def test_fused_over_devices_matches_jax(runs, run):
    """The port's stage with frames over three devices, and
    ``seg_patch_fused`` with two site groups over three devices, write the
    JAX package's site pickles, stacks and probabilities (the JAX runs
    here are one-device; its own 8-device runs are held in
    tests/test_torch_stream.py), exactly as one device does."""
    for name in ("cell_positions.pkl", "cell_pixel_assignments.pkl"):
        _assert_same(load_pickle(os.path.join(runs[run][1], name)),
                     load_pickle(os.path.join(runs["jax"][1], name)), name)
    ours, ref = _stacks(runs, run), _stacks(runs, "jax")
    for t in range(T):
        _assert_same(ours[t], ref[t], f"stacks_{t}")
    site = SITE if run == "port_fanout" else run
    np.testing.assert_array_equal(
        np.load(os.path.join(runs[run][0], f"{site}_NNProbabilities.npy")),
        np.load(_site_files(runs, "jax", "_NNProbabilities.npy")))


def test_fused_skip_boundary_matches_jax(runs):
    """skip_boundary drops the cells whose window crosses the frame edge,
    as in the JAX stage; the probabilities are those of every pixel."""
    for name in ("cell_positions.pkl", "cell_pixel_assignments.pkl"):
        _assert_same(load_pickle(os.path.join(runs["port_skip"][1], name)),
                     load_pickle(os.path.join(runs["jax_skip"][1], name)))
    ours, ref = _stacks(runs, "port_skip"), _stacks(runs, "jax_skip")
    for t in range(T):
        _assert_same(ours[t], ref[t], f"stacks_{t}")
    cp = load_pickle(os.path.join(runs["port_skip"][1], "cell_positions.pkl"))
    assert [len(cp[t]) for t in range(T)] == [0, 0, 1]
    np.testing.assert_array_equal(
        np.load(_site_files(runs, "port_skip", "_NNProbabilities.npy")),
        np.load(_site_files(runs, "jax_skip", "_NNProbabilities.npy")))


# ---------------------------------------- the stage vs the port's staged path


def _assert_same_tree(runs, a, b):
    for name in ("cell_positions.pkl", "cell_pixel_assignments.pkl"):
        _assert_same(load_pickle(os.path.join(runs[a][1], name)),
                     load_pickle(os.path.join(runs[b][1], name)), name)
    sa, sb = _stacks(runs, a), _stacks(runs, b)
    for t in range(T):
        _assert_same(sa[t], sb[t], f"stacks_{t}")
    assert sorted(os.listdir(runs[a][1])) == sorted(os.listdir(runs[b][1]))
    for f in os.listdir(runs[a][1]):
        if f.endswith(".png"):
            np.testing.assert_array_equal(
                _png(os.path.join(runs[a][1], f)),
                _png(os.path.join(runs[b][1], f)), err_msg=f)
    for suffix in ("_NNProbabilities.npy", ".png", "_NNpred.png"):
        fa, fb = _site_files(runs, a, suffix), _site_files(runs, b, suffix)
        load = np.load if suffix.endswith(".npy") else _png
        x, y = load(fa), load(fb)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y, err_msg=suffix)


def test_fused_matches_port_staged(runs):
    """The fused stage writes the staged path's artifacts (segmentation in
    direct mode, instance_segmentation, extract_patches) exactly, the
    instance-map PNGs included."""
    _assert_same_tree(runs, "port", "staged")


@pytest.mark.parametrize("schedule", ["one_worker", "two_workers"])
def test_fused_schedule_changes_nothing(runs, schedule):
    """cluster_workers=1 (one frame ahead) and 2 write what 3 workers
    write."""
    _assert_same_tree(runs, schedule, "port")


def test_fused_counts_the_bytes_it_moves(runs):
    """The stage's own count of its copies, per frame: up, the two uint16
    channels (the stack is uint16), the foreground pixels as int16
    (y, x, label) and 12 bytes a cell (centre, id); down, the mask at one
    bit a pixel, the patches (mat and masked_mat float32, tm and tm2
    uint8) and the float32 probabilities."""
    pixels = load_pickle(os.path.join(runs["port"][1],
                                      "cell_pixel_assignments.pkl"))
    n_fg = sum(len(pixels[t][0]) for t in range(T))
    cells = 3 * T
    assert runs["moved"] == {
        "frames": T,
        "h2d_bytes": T * 2 * 64 * 64 * 2 + 6 * n_fg + 12 * cells,
        "d2h_bytes": T * (64 * 64 // 8 + 3 * 64 * 64 * 4)
        + cells * (2 * 2 * WINDOW * WINDOW * 4 + 2 * WINDOW * WINDOW)}


def test_fused_empty_frames_write_no_png(tmp_path):
    """A frame below the foreground early-out writes no instance map, and
    an empty stacks pickle, as the staged path does."""
    stack = np.full((2, 2, 1, 64, 64), 10000, np.uint16)
    site = str(tmp_path / f"{SITE}.npy")
    np.save(site, stack)
    supp = str(tmp_path / "supp")
    run_port_fused(site, supp)
    for t in range(2):
        assert not os.path.exists(os.path.join(supp,
                                               f"segmentation_{t}.png"))
        assert load_pickle(os.path.join(supp, f"stacks_{t}.pkl")) == {}


def test_fused_completion_marker_written_last(tmp_path, monkeypatch):
    """cell_positions.pkl is the resume marker: a failure in the trailing
    probability save leaves the site unmarked."""
    site = _make_site(tmp_path, SITE)
    supp = str(tmp_path / "supp")
    real_save = np.save

    def boom(path, *a, **k):
        if "NNProbabilities" in str(path):
            raise OSError("disk full")
        return real_save(path, *a, **k)

    monkeypatch.setattr(np, "save", boom)
    with pytest.raises(OSError, match="disk full"):
        run_port_fused(site, supp)
    assert not os.path.exists(os.path.join(supp, "cell_positions.pkl"))
    assert os.path.exists(os.path.join(supp, "stacks_2.pkl"))


def _config(weights="unused"):
    from dynamorph_tpu_torch.config.schema import PipelineConfig

    config = PipelineConfig()
    config.segmentation_inference.channels = CHANNELS
    config.segmentation_inference.weights = weights
    config.patch.channels = CHANNELS
    config.patch.window_size = WINDOW
    return config


def test_seg_patch_fused_rerun_false_skips_completed(tmp_path, monkeypatch):
    """rerun=False skips a site whose completion marker exists; a missing
    site is reported as failed; the stage goes on."""
    _make_site(tmp_path, SITE)
    supp = tmp_path / "supp"
    done = supp / "C5-supps" / SITE
    done.mkdir(parents=True)
    save_pickle({}, str(done / "cell_positions.pkl"))
    called = []
    monkeypatch.setattr(fused, "process_site_seg_patch_fused",
                        lambda *a, **k: called.append(a[0]))
    failed = fused.seg_patch_fused(str(tmp_path), str(supp),
                                   [SITE, "C5-Site_9"], _config(),
                                   rerun=False, model=TorchStub(),
                                   device="cpu")
    assert called == []
    assert [s for s, _ in failed] == ["C5-Site_9"]
    failed = fused.seg_patch_fused(str(tmp_path), str(supp), [SITE],
                                   _config(), model=TorchStub(),
                                   device="cpu")
    assert failed == [] and called == [os.path.join(str(tmp_path),
                                                    f"{SITE}.npy")]


def test_build_seg_model_refuses_other_networks_and_no_weights():
    config = _config()
    config.segmentation_inference.network = "ResNet50"
    with pytest.raises(NotImplementedError, match="ResNet50"):
        fused.build_seg_model(config, device="cpu")
    with pytest.raises(ValueError, match="weights"):
        fused.build_seg_model(_config(weights=None), device="cpu")


def test_seg_patch_fused_logs_a_failing_site_and_goes_on(tmp_path,
                                                        monkeypatch):
    """A site whose stack is not 5-D fails alone (per-site tolerance)."""
    _stub_port(monkeypatch)
    _make_site(tmp_path, SITE)
    np.save(tmp_path / "C5-Site_1.npy", np.zeros((2, 64, 64), np.uint16))
    failed = fused.seg_patch_fused(str(tmp_path), str(tmp_path / "supp"),
                                   ["C5-Site_1", SITE], _config(),
                                   model=TorchStub(), device="cpu")
    assert [s for s, _ in failed] == ["C5-Site_1"]
    assert "5-D" in str(failed[0][1])
    assert os.path.exists(tmp_path / "supp" / "C5-supps" / SITE /
                          "cell_positions.pkl")


def test_run_pipeline_fused_cli_matches_jax(tmp_path, monkeypatch):
    """``run_pipeline --fused`` over the three front-end stages runs the
    one fused stage, as the JAX package's run_pipeline does with
    patch.fused, writes the fused stage's artifacts, and skips it when
    resumed."""
    from dynamorph_tpu.config.schema import PipelineConfig as JaxPC
    from dynamorph_tpu.pipeline.orchestrator import \
        run_pipeline as jax_run_pipeline
    from dynamorph_tpu_torch.cli import run_pipeline

    front = ["segmentation", "instance_segmentation", "extract_patches"]
    _stub_port(monkeypatch)
    _stub_jax(monkeypatch)
    raw, jraw = tmp_path / "port", tmp_path / "jax"
    for d in (raw, jraw):
        _make_site(d, SITE)
    cfg = tmp_path / "cfg.yml"
    cfg.write_text(
        f"patch:\n  raw_dirs: ['{raw}']\n  supp_dirs: ['{raw / 'supp'}']\n"
        f"  channels: {CHANNELS}\n  window_size: {WINDOW}\n"
        f"segmentation_inference:\n  channels: {CHANNELS}\n"
        "  weights: 'unused'\n")
    jcfg = JaxPC()
    jcfg.segmentation_inference.channels = CHANNELS
    jcfg.segmentation_inference.weights = "unused"
    jcfg.patch.channels = CHANNELS
    jcfg.patch.window_size = WINDOW
    jcfg.patch.fused = True
    argv = ["-c", str(cfg), "--fused", "--stages", *front, "--device", "cpu"]
    for want in (["seg_patch_fused"], []):
        got = run_pipeline.main(argv)
        ref = jax_run_pipeline(str(jraw), str(jraw / "supp"), [SITE], jcfg,
                               stages=front)
        assert got == {str(raw): want} and ref == want
    dirs = {"cli": (str(raw), str(raw / "supp" / "C5-supps" / SITE)),
            "jax_cli": (str(jraw), str(jraw / "supp" / "C5-supps" / SITE))}
    for name in ("cell_positions.pkl", "cell_pixel_assignments.pkl"):
        _assert_same(load_pickle(os.path.join(dirs["cli"][1], name)),
                     load_pickle(os.path.join(dirs["jax_cli"][1], name)))
    np.testing.assert_array_equal(
        np.load(_site_files(dirs, "cli", "_NNProbabilities.npy")),
        np.load(_site_files(dirs, "jax_cli", "_NNProbabilities.npy")))
    for t in range(T):
        a = {os.path.basename(k): v for k, v in load_pickle(
            os.path.join(dirs["cli"][1], f"stacks_{t}.pkl")).items()}
        b = {os.path.basename(k): v for k, v in load_pickle(
            os.path.join(dirs["jax_cli"][1], f"stacks_{t}.pkl")).items()}
        assert len(a) == 3
        _assert_same(a, b, f"stacks_{t}")
