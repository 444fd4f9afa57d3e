"""The port's U-Net semantic segmentation (``models/unet.py``, ``seg/``,
``pipeline/segmentation.py``, ``cli/run_segmentation.py``, ``io/png.py``)
against the JAX package on the CPU, on the same weights bridged through
numpy.

One module-scoped JAX ``Segment`` at input (2, 32, 32), with its batch-norm
running statistics, scales and offsets moved off the identity and its head
scaled so the logits are O(1): random init alone leaves batch norm near the
identity and the logits near 0.2, where a parity check sees little. The JAX
side compiles three programs: the logits, the tile batch of 8 and one
direct frame batch of 4.

Tolerances: logits within 1e-4 of max|logit| (fp32 summation order, XLA-CPU
against oneDNN), probabilities within 1e-5.
"""
import os

import cv2
import numpy as np
import pytest
import torch

import jax

from dynamorph_tpu.config.schema import (PipelineConfig as JaxPC,
                                         SegmentationInferenceConfig as JaxSI)
from dynamorph_tpu.pipeline import segmentation as jax_pipeline
from dynamorph_tpu.seg.inference import predict_whole_map as jax_whole_map
from dynamorph_tpu.seg.model import Segment as JaxSegment
from dynamorph_tpu_torch.cli import run_segmentation
from dynamorph_tpu_torch.io.png import write_png
from dynamorph_tpu_torch.models.jax_import import state_dict_from_jax
from dynamorph_tpu_torch.seg.data import plot_prediction_prob
from dynamorph_tpu_torch.seg.inference import predict_whole_map
from dynamorph_tpu_torch.seg.model import Segment
from test_torch_train import _few_threads  # noqa: F401

WINDOW = 32
LOGIT_RTOL = 1e-4
PROB_ATOL = 1e-5
SITES = ["B2-Site_0", "B2-Site_1"]
N_SUPP = 3


def _perturb(tree, r):
    """Batch-norm leaves off the identity: running mean N(0, 0.2), var
    U(0.5, 1.5), scale U(0.7, 1.3), offset N(0, 0.2)."""
    if isinstance(tree, list):
        return [_perturb(v, r) for v in tree]
    if not isinstance(tree, dict):
        return tree
    if "mean" in tree and "var" in tree:
        n = len(tree["mean"])
        return {"mean": (0.2 * r.randn(n)).astype(np.float32),
                "var": r.uniform(0.5, 1.5, n).astype(np.float32)}
    if "scale" in tree and "offset" in tree:
        n = len(tree["scale"])
        return {"scale": r.uniform(0.7, 1.3, n).astype(np.float32),
                "offset": (0.2 * r.randn(n)).astype(np.float32)}
    return {k: _perturb(v, r) for k, v in tree.items()}


@pytest.fixture(scope="module")
def models():
    """(JAX Segment, the port's Segment on the CPU) on the same weights."""
    jm = JaxSegment(input_shape=(2, WINDOW, WINDOW), n_classes=3)
    params, state = jax.device_get((jm.params, jm.state))
    r = np.random.RandomState(0)
    params, state = _perturb(params, r), _perturb(state, r)
    params["head"] = dict(params["head"], kernel=params["head"]["kernel"] * 10)
    jm.params, jm.state = params, state
    pm = Segment(input_shape=(2, WINDOW, WINDOW), n_classes=3, device="cpu")
    pm.net.load_state_dict(state_dict_from_jax(params, state, "UNet"),
                           strict=True)
    return jm, pm


def _stack(seed, n_channels=2):
    """(2, C, 1, 64, 64) float64 raw intensities in the uint16 range."""
    return np.random.RandomState(seed).rand(2, n_channels, 1, 64, 64) * 65535


class _Recorder:
    """An np.random-like source that records the offsets it hands out."""

    def __init__(self, seed):
        self.rs, self.draws = np.random.RandomState(seed), []

    def randint(self, lo, hi):
        v = self.rs.randint(lo, hi)
        self.draws.append(v)
        return v


def test_unet_logits_match_jax(models):
    jm, pm = models
    x = np.random.RandomState(1).rand(2, 2, 64, 64).astype(np.float32)
    lj = np.asarray(jax.jit(lambda p, s, x: jm.net.apply(
        p, s, x, train=False)[0])(jm.params, jm.state, x))
    with torch.no_grad():
        lt = pm.net(torch.from_numpy(x)).numpy()
    assert lt.shape == lj.shape == (2, 3, 64, 64)
    assert np.abs(lt - lj).max() <= LOGIT_RTOL * np.abs(lj).max()
    assert np.abs(lj).max() > 1.0          # the check sees O(1) logits
    pj = np.asarray(jax.nn.softmax(lj, axis=1))
    pt = torch.softmax(torch.from_numpy(lt), 1).numpy()
    np.testing.assert_allclose(pt, pj, atol=PROB_ATOL, rtol=0)


def test_bridge_names_and_save_load_roundtrip(models, tmp_path):
    """The bridged dict holds every parameter and buffer of the port's
    U-Net; a model.pt saved as a file or in a directory loads strictly and
    gives the same probabilities."""
    jm, pm = models
    sd = state_dict_from_jax(jm.params, jm.state, "UNet")
    ref = pm.net.state_dict()
    assert sorted(sd) == sorted(ref)
    assert all(sd[k].shape == ref[k].shape for k in sd)
    assert "encoder.layer2.0.downsample.1.running_var" in sd
    assert "decoder.blocks.4.conv2.1.weight" in sd
    x = np.random.RandomState(2).rand(3, 2, WINDOW, WINDOW).astype(np.float32)
    want = pm.predict(x)
    for target in (str(tmp_path / "weights"), str(tmp_path / "unet.pt")):
        pm.save(target)
        fresh = Segment(input_shape=(2, WINDOW, WINDOW), seed=1,
                        device="cpu")
        fresh.load(target)
        np.testing.assert_array_equal(fresh.predict(x), want)
    assert os.path.exists(tmp_path / "weights" / "model.pt")


def test_predict_whole_map_tiled_matches_jax(models):
    jm, pm = models
    stack = _stack(3)
    rj, rt = _Recorder(0), _Recorder(0)
    pj = jax_whole_map(stack, jm, n_supp=N_SUPP, rng=rj)
    pt = predict_whole_map(stack, pm, n_supp=N_SUPP, rng=rt)
    assert rt.draws == rj.draws and len(rt.draws) == 2 * 2 * N_SUPP
    assert pt.shape == pj.shape == (2, 3, 1, 64, 64)
    assert pt.dtype == pj.dtype == np.float64
    assert not (pt == -1).any()
    np.testing.assert_allclose(pt, pj, atol=PROB_ATOL, rtol=0)


def test_predict_whole_map_direct_matches_jax(models):
    jm, pm = models
    stack = _stack(4)
    pj = jax_whole_map(stack, jm, mode="direct")
    pt = predict_whole_map(stack, pm, mode="direct")
    assert pt.shape == pj.shape == (2, 3, 1, 64, 64)
    assert pt.dtype == np.float32 and pj.dtype == np.float32
    np.testing.assert_allclose(pt, pj, atol=PROB_ATOL, rtol=0)


def test_predict_patch_list_matches_jax(models):
    """``Segment.predict`` on a list of (input, label) patch pairs scales
    through ``preprocess`` as the JAX package's does; the probabilities
    match the JAX model's on the same raw tiles (its tile program)."""
    from dynamorph_tpu.seg.data import preprocess as jax_preprocess
    from dynamorph_tpu.seg.inference import _scaled_predict_fn
    from dynamorph_tpu_torch.seg.data import preprocess

    jm, pm = models
    r = np.random.RandomState(8)
    raw = r.rand(8, 2, 1, WINDOW, WINDOW) * 65535
    labels = r.randint(0, 4, (8, 1, 1, WINDOW, WINDOW))
    for kind, lab in (("prob", r.rand(8, 3, 1, WINDOW, WINDOW)),
                      ("annotation", labels)):
        pairs = [[x, y] for x, y in zip(raw, lab)]
        for got, want in zip(preprocess(pairs, label_input=kind),
                             jax_preprocess(pairs, label_input=kind)):
            np.testing.assert_array_equal(got, want)
    pt = pm.predict([[x, y] for x, y in zip(raw, labels)],
                    label_input=None)
    pj = np.asarray(_scaled_predict_fn(jm)(
        jm.params, jm.state, raw[:, :, 0].astype(np.float32)))
    assert pt.shape == pj.shape == (8, 3, 1, WINDOW, WINDOW)
    np.testing.assert_allclose(pt, pj, atol=PROB_ATOL, rtol=0)


@pytest.mark.parametrize("ext", [".npy", ".h5"])
def test_load_input_matches_jax(ext, tmp_path):
    from dynamorph_tpu.seg.data import load_input as jax_load_input
    from dynamorph_tpu_torch.seg.data import load_input

    stack = _stack(9)
    path = str(tmp_path / f"site{ext}")
    if ext == ".npy":
        np.save(path, stack)
    else:
        import h5py

        with h5py.File(path, "w") as f:
            for t, frame in enumerate(stack):
                f.create_dataset(f"t{t:03d}", data=frame)
    np.testing.assert_array_equal(load_input(path), jax_load_input(path))
    np.testing.assert_array_equal(load_input(path), stack)


@pytest.fixture(scope="module")
def site_dirs(models, tmp_path_factory):
    """Two copies of a two-site raw dir ((2, 3, 1, 64, 64) float64 sites, as
    run_preproc writes them), the JAX model saved by JAX ``Segment.save``
    (an orbax directory) and the port's model.pt."""
    jm, pm = models
    root = tmp_path_factory.mktemp("seg")
    dirs = {k: root / k for k in ("jax_raw", "port_raw", "supp")}
    for d in dirs.values():
        d.mkdir()
    for i, site in enumerate(SITES):
        stack = _stack(10 + i, n_channels=3)
        for k in ("jax_raw", "port_raw"):
            np.save(dirs[k] / f"{site}.npy", stack)
    jm.save(str(root / "orbax"))
    pm.save(str(root / "port_weights"))
    return {k: str(v) for k, v in dirs.items()}, str(root / "orbax"), \
        str(root / "port_weights")


def test_run_segmentation_cli_matches_jax(models, site_dirs, tmp_path,
                                          monkeypatch):
    """``run_segmentation -m segmentation --device cpu`` on a two-site raw
    dir against the JAX package's ``segmentation()`` on a copy, under the
    same global numpy seed: probabilities within 1e-5, the raw-frame PNG
    pixel-equal, and the prediction PNG pixel-equal to the JAX package's
    wherever the two float64 maps do not straddle a rounding boundary."""
    jm, _ = models
    dirs, orbax_dir, port_weights = site_dirs
    # the JAX stage builds its own Segment; hand it the module's model so
    # its compiled tile program is reused (the stage still loads the orbax
    # checkpoint into it)
    monkeypatch.setattr(jax_pipeline, "Segment", lambda **kw: jm)
    cfg = JaxPC(segmentation_inference=JaxSI(
        channels=[0, 1], window_size=WINDOW, num_pred_rnd=N_SUPP,
        weights=orbax_dir))
    np.random.seed(7)
    jax_pipeline.segmentation(dirs["jax_raw"], dirs["supp"], None, SITES, cfg)

    yml = tmp_path / "cfg.yml"
    yml.write_text(
        "segmentation_inference:\n"
        f"  raw_dirs: ['{dirs['port_raw']}']\n"
        f"  supp_dirs: ['{dirs['supp']}']\n"
        f"  weights: '{port_weights}'\n  channels: [0, 1]\n"
        f"  window_size: {WINDOW}\n  num_pred_rnd: {N_SUPP}\n")
    np.random.seed(7)
    run_segmentation.main(["-m", "segmentation", "-c", str(yml),
                           "--device", "cpu"])

    for site in SITES:
        pj = np.load(os.path.join(dirs["jax_raw"],
                                  f"{site}_NNProbabilities.npy"))
        pt = np.load(os.path.join(dirs["port_raw"],
                                  f"{site}_NNProbabilities.npy"))
        assert pt.shape == pj.shape == (2, 3, 1, 64, 64)
        assert pt.dtype == pj.dtype == np.float64
        np.testing.assert_allclose(pt, pj, atol=PROB_ATOL, rtol=0)

        def png(d, name):
            return cv2.imread(os.path.join(d, name), cv2.IMREAD_UNCHANGED)

        np.testing.assert_array_equal(png(dirs["port_raw"], f"{site}.png"),
                                      png(dirs["jax_raw"], f"{site}.png"))
        # the port's preview writer on the JAX probabilities gives the JAX
        # package's file exactly
        plot_prediction_prob(pj[0], str(tmp_path / "from_jax.png"))
        want = png(dirs["jax_raw"], f"{site}_NNpred.png")
        np.testing.assert_array_equal(png(str(tmp_path), "from_jax.png"),
                                      want)
        got = png(dirs["port_raw"], f"{site}_NNpred.png")
        assert got.shape == want.shape == (64, 64, 4)
        mat = _pred_mat(pj[0])
        diff = got.astype(int) != want.astype(int)
        # a pixel may differ only by one step, where the JAX value lies
        # within the probability tolerance's reach of a half-integer
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
        near = np.abs(mat - np.floor(mat) - 0.5) <= 255 * 2 * PROB_ATOL
        assert not (diff & ~near).any()


def _pred_mat(d1):
    """The float64 BGRA mat of ``plot_prediction_prob``, in cv2's channel
    order as decoded."""
    m = np.zeros(d1.shape[-2:] + (4,))
    m[..., :3] = d1[1, 0][..., None] * [200, 130, 0] + \
        d1[2, 0][..., None] * [75, 25, 230]
    m[..., 3] = (d1[1, 0] + d1[2, 0]) * 255
    return m


@pytest.mark.parametrize("case", ["gray_rounding", "gray_random", "bgra",
                                  "bgr", "uint16", "uint8"])
def test_png_matches_cv2(case, tmp_path):
    """write_png decodes to cv2.imwrite's pixels: float64 gray with cv2's
    saturating round half to even, 3-channel BGR (the instance maps),
    4-channel BGRA, and integer images."""
    r = np.random.RandomState(5)
    image = {
        "gray_rounding": np.array([[0.5, 1.5, 2.5, 254.5, 300.0, -3.0],
                                   [0.49, 0.51, 255.5, 253.5, 1e9, -1e9]]),
        "gray_random": r.randn(37, 53) * 200 + 100,
        "bgra": r.rand(19, 23, 4) * 300 - 20,
        "bgr": r.randint(0, 256, (13, 11, 3)).astype(np.uint8),
        "uint16": r.randint(0, 65536, (17, 29)).astype(np.uint16),
        "uint8": r.randint(0, 256, (5, 7)).astype(np.uint8),
    }[case]
    cv2.imwrite(str(tmp_path / "cv2.png"), image)
    write_png(str(tmp_path / "port.png"), image)
    want = cv2.imread(str(tmp_path / "cv2.png"), cv2.IMREAD_UNCHANGED)
    got = cv2.imread(str(tmp_path / "port.png"), cv2.IMREAD_UNCHANGED)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    if case == "gray_rounding":
        assert got.tolist() == [[0, 2, 2, 254, 255, 0],
                                [0, 1, 255, 254, 255, 0]]


def test_load_refuses_orbax_dir(site_dirs):
    _, orbax_dir, _ = site_dirs
    with pytest.raises(ValueError, match="state_dict_from_jax"):
        Segment(input_shape=(2, WINDOW, WINDOW), device="cpu").load(orbax_dir)


def test_load_refuses_keras_h5(tmp_path):
    with pytest.raises(NotImplementedError, match="keras_import"):
        Segment(input_shape=(2, WINDOW, WINDOW), device="cpu").load(
            str(tmp_path / "weights.h5"))


def test_time_slices_refused(models):
    _, pm = models
    with pytest.raises(NotImplementedError, match="SegmentWithMultipleSlice"):
        predict_whole_map(_stack(6), pm, time_slices=3)


def test_fused_stage_real_unet_matches_jax(models, tmp_path, monkeypatch):
    """The fused seg -> instance -> patch stage (pipeline/fused.py) with
    this module's U-Net: its probabilities within 1e-5 of the JAX fused
    stage's on the fused tests' 3-frame 64 x 64 site. The U-Net runs at
    batch 1 on the whole frame in both packages."""
    from test_torch_fused import SITE, T, _make_site, _run_jax_fused, \
        run_port_fused

    jm, pm = models
    for name in ("jax", "port"):
        _make_site(tmp_path / name, SITE)
    _run_jax_fused(str(tmp_path / "jax" / f"{SITE}.npy"),
                   str(tmp_path / "jax" / "supp"), monkeypatch, model=jm)
    run_port_fused(str(tmp_path / "port" / f"{SITE}.npy"),
                   str(tmp_path / "port" / "supp"), model=pm)
    ours = np.load(tmp_path / "port" / f"{SITE}_NNProbabilities.npy")
    ref = np.load(tmp_path / "jax" / f"{SITE}_NNProbabilities.npy")
    assert ours.shape == ref.shape == (T, 3, 1, 64, 64)
    assert ours.dtype == ref.dtype == np.float32
    np.testing.assert_allclose(ours, ref, atol=PROB_ATOL, rtol=0)
    assert np.ptp(ref) > 0.1               # the check sees real structure
    assert os.path.exists(tmp_path / "port" / "supp" / "cell_positions.pkl")


def _validation_site(raw, supp):
    """A 3-frame 2 x 48 x 56 site with 3 disk cells a frame: float64 raw
    intensities, (T, 3, 1, H, W) probabilities in which cell 1 is MG
    (class 2 over class 1) and the others non-MG, the instance pickles
    (cell 2 dropped from the kept cells, noise pixels labelled -1)."""
    r = np.random.RandomState(12)
    t_len, h, w = 3, 48, 56
    yy, xx = np.mgrid[:h, :w]
    raw_stack = r.randint(20000, 30000, (t_len, 2, 1, h, w)).astype(float)
    probs = np.zeros((t_len, 3, 1, h, w))
    probs[:, 0] = 0.9
    probs[:, 1] = 0.05
    probs[:, 2] = 0.05
    positions, assignments = {}, {}
    for t in range(t_len):
        lab = np.full((h, w), -1)
        for cid, (cy, cx) in enumerate([(12, 12), (14, 40), (34, 26)]):
            cell = (yy - cy - t) ** 2 + (xx - cx) ** 2 < 7 ** 2
            lab[cell] = cid
            probs[t, :, 0][:, cell] = [[0.1], [0.3], [0.6]] if cid == 1 \
                else [[0.1], [0.7], [0.2]]
        lab[0, :3] = -1
        pix = np.argwhere(lab >= 0)
        pix = np.concatenate([pix, [[0, 0], [0, 1]]])
        labels = np.concatenate([lab[pix[:-2, 0], pix[:-2, 1]], [-1, -1]])
        assignments[t] = (pix, labels.astype(np.int32))
        positions[t] = [(np.int32(c), np.array(p)) for c, p in
                        enumerate([(12 + t, 12), (14 + t, 40)])]
    np.save(os.path.join(raw, "B2-Site_0.npy"), raw_stack)
    np.save(os.path.join(raw, "B2-Site_0_NNProbabilities.npy"), probs)
    folder = os.path.join(supp, "B2-supps", "B2-Site_0")
    os.makedirs(folder)
    from dynamorph_tpu_torch.io.pickles import save_pickle

    save_pickle(positions, os.path.join(folder, "cell_positions.pkl"))
    save_pickle(assignments, os.path.join(folder,
                                          "cell_pixel_assignments.pkl"))


@pytest.mark.parametrize("category", ["mg", "nonmg", "both", "unfiltered"])
def test_segmentation_validation_matches_jax(category, tmp_path):
    """``run_segmentation -m segmentation_validation --device cpu`` writes
    the JAX package's multipage uint16 RGB TIFF, byte for byte and as cv2
    reads it: green rims for non-MG cells, red for MG, of the kept cells
    of the category (every cluster for "unfiltered")."""
    dirs = {}
    for pkg in ("jax", "port"):
        raw, supp = tmp_path / f"{pkg}_raw", tmp_path / f"{pkg}_supp"
        raw.mkdir()
        _validation_site(str(raw), str(supp))
        dirs[pkg] = (str(raw), str(supp))
    cfg = JaxPC(segmentation_inference=JaxSI(seg_val_cat=category))
    jax_pipeline.segmentation_validation(*dirs["jax"], None, ["B2-Site_0"],
                                         cfg)
    yml = tmp_path / "cfg.yml"
    yml.write_text(
        "segmentation_inference:\n"
        f"  raw_dirs: ['{dirs['port'][0]}']\n"
        f"  supp_dirs: ['{dirs['port'][1]}']\n"
        f"  seg_val_cat: '{category}'\n")
    run_segmentation.main(["-m", "segmentation_validation", "-c", str(yml),
                           "--device", "cpu"])
    paths = {pkg: os.path.join(dirs[pkg][1], "validation_images",
                               "B2-Site_0_predictions.tif") for pkg in dirs}
    with open(paths["port"], "rb") as a, open(paths["jax"], "rb") as b:
        assert a.read() == b.read()
    ok, pages = cv2.imreadmulti(paths["port"], flags=cv2.IMREAD_UNCHANGED)
    ok_j, pages_j = cv2.imreadmulti(paths["jax"], flags=cv2.IMREAD_UNCHANGED)
    assert ok and ok_j and len(pages) == len(pages_j) == 3
    for page, ref in zip(pages, pages_j):
        assert page.dtype == np.uint16 and page.shape == (48, 56, 3)
        np.testing.assert_array_equal(page, ref)
    # cv2 reads BGR: red rims (MG, cell 1) and green ones (non-MG)
    red = (pages[0] == [0, 0, 65535]).all(-1).sum()
    green = (pages[0] == [0, 65535, 0]).all(-1).sum()
    want = {"mg": (True, False), "nonmg": (False, True),
            "both": (True, True), "unfiltered": (True, True)}[category]
    assert (red > 0, green > 0) == want


def test_find_rim_matches_jax():
    from dynamorph_tpu.pipeline.segmentation import find_rim as jax_find_rim
    from dynamorph_tpu_torch.pipeline.segmentation import find_rim

    yy, xx = np.mgrid[:20, :20]
    pts = np.argwhere((yy - 9) ** 2 + (xx - 10) ** 2 < 36)
    ours, ref = find_rim(pts), jax_find_rim(pts)
    assert sorted(map(tuple, ours)) == sorted(map(tuple, ref))
    assert 0 < len(ours) < len(pts)


def test_run_segmentation_raises_without_card(site_dirs, tmp_path):
    """No CPU fallback: without a card the CLI's default device raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    dirs, _, port_weights = site_dirs
    yml = tmp_path / "cfg.yml"
    yml.write_text(
        "segmentation_inference:\n"
        f"  raw_dirs: ['{dirs['port_raw']}']\n"
        f"  supp_dirs: ['{dirs['supp']}']\n  weights: '{port_weights}'\n")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_segmentation.main(["-m", "segmentation", "-c", str(yml)])
