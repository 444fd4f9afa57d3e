"""The port's U-Net semantic segmentation (``models/unet.py``, ``seg/``,
``pipeline/segmentation.py``, ``cli/run_segmentation.py``, ``io/png.py``)
against the JAX package on the CPU, on the same weights bridged through
numpy.

One module-scoped JAX ``Segment`` at input (2, 32, 32), with its batch-norm
running statistics, scales and offsets moved off the identity and its head
scaled so the logits are O(1): random init alone leaves batch norm near the
identity and the logits near 0.2, where a parity check sees little. Its
weights are drawn with numpy in the JAX init's distribution
(``_bare_jax_segment``: the shapes from ``jax.eval_shape``, so the JAX
package's jitted init, 15 s of this file, is not compiled). The JAX side
compiles the logits, the tile batch of 8, one direct frame batch of 4, the
fit's train step and validation batch, and the multi-slice tile batch.

Slice H adds ``Segment.fit`` against the JAX package's on copied weights
(at lr 1e-6 on both; see ``test_fit_matches_jax``), ``freeze_encoder``,
``encoder_weights``, ReduceLROnPlateau, the metrics against sklearn,
``SegmentWithMultipleSlice`` and ``predict_whole_map(time_slices=2)``.

Tolerances: logits within 1e-4 of max|logit| (fp32 summation order, XLA-CPU
against oneDNN), probabilities within 1e-5.
"""
import copy
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
from dynamorph_tpu_torch.seg.model import Segment, SegmentWithMultipleSlice
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


def _init_like_jax(shapes, seed):
    """Numpy draws in the JAX init's distribution on ``shapes`` (a tree of
    ShapeDtypeStructs): kernels and biases U(-1/sqrt(fan_in), 1/sqrt(fan_in))
    (``init_conv``), batch norm at the identity."""
    r = np.random.RandomState(seed)
    fan_in = {}

    def draw(path, leaf):
        names = [str(getattr(k, "key", getattr(k, "idx", ""))) for k in path]
        shape, name = leaf.shape, names[-1]
        if name == "kernel":
            fan_in[tuple(names[:-1])] = int(np.prod(shape[:-1]))
        if name in ("kernel", "bias"):
            b = 1 / np.sqrt(fan_in.get(tuple(names[:-1]), shape[0]))
            v = r.uniform(-b, b, shape)
        elif name in ("scale", "var"):
            v = np.ones(shape)
        else:                                   # offset, running mean
            v = np.zeros(shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _bare_jax_segment(cls, input_shape, seed=0, **attrs):
    """A JAX ``Segment`` (or subclass) built as its ``__init__`` does but
    for the jitted init: the network comes from tracing ``_init_net`` with
    ``jax.eval_shape`` (no compile), the weights from ``_init_like_jax``."""
    import tempfile

    jm = cls.__new__(cls)
    for k, v in attrs.items():
        setattr(jm, k, v)
    jm.input_shape = tuple(input_shape)
    jm.n_channels = jm.input_shape[0]
    jm.x_size, jm.y_size = jm.input_shape[-2:]
    jm.n_classes = 3
    jm.freeze_encoder = False
    jm.model_path = tempfile.mkdtemp()
    if len(input_shape) == 4:
        jm.n_slices = input_shape[1]
    shapes = jax.eval_shape(jm._init_net, jax.random.PRNGKey(seed))
    jm.params, jm.state = jax.device_put(_init_like_jax(shapes, seed))
    jm._predict_fn = jax.jit(jm._predict_impl)
    jm._lr = 1e-3
    return jm


@pytest.fixture(scope="module")
def models():
    """(JAX Segment, the port's Segment on the CPU) on the same weights."""
    jm = _bare_jax_segment(JaxSegment, (2, WINDOW, WINDOW))
    params, state = jax.device_get((jm.params, jm.state))
    r = np.random.RandomState(0)
    params, state = _perturb(params, r), _perturb(state, r)
    params["head"] = dict(params["head"], kernel=params["head"]["kernel"] * 10)
    # on the device: numpy leaves would upload all 24M weights every call
    jm.params, jm.state = jax.device_put((params, state))
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
    """A Keras ``.h5`` is no longer refused as a format: ``Segment.load``
    imports a reference U-Net's into the Keras graph
    (``tests/test_torch_keras_unet.py`` holds it against the JAX package),
    and refuses, with the JAX package's ValueError, an ``.h5`` that holds
    no such model."""
    import h5py

    from dynamorph_tpu_torch.models.unet_keras import KerasUNet
    from test_keras_import import write_keras_h5
    from test_torch_keras_unet import keras_unet_weights

    path = str(tmp_path / "weights.h5")
    write_keras_h5(path, keras_unet_weights(6))
    model = Segment(input_shape=(2, WINDOW, WINDOW), device="cpu")
    model.load(path)
    assert isinstance(model.net, KerasUNet)
    other = str(tmp_path / "other.h5")
    with h5py.File(other, "w") as f:
        f.create_dataset("dense/dense/kernel:0", data=np.zeros((4, 4)))
    with pytest.raises(ValueError, match="missing layer 'pre_conv'"):
        Segment(input_shape=(2, WINDOW, WINDOW), device="cpu").load(other)


def test_time_slices_refused(models):
    """time_slices > 1 needs a SegmentWithMultipleSlice of as many slices:
    a plain Segment is refused (the JAX package fails on its shape
    assert), and so is the direct mode."""
    _, pm = models
    with pytest.raises(ValueError, match="SegmentWithMultipleSlice"):
        predict_whole_map(_stack(6), pm, time_slices=3)
    ms = SegmentWithMultipleSlice(unet_feat=4, input_shape=(2, 2, WINDOW,
                                                            WINDOW),
                                  device="cpu")
    with pytest.raises(ValueError, match="tiled"):
        predict_whole_map(_stack(6), ms, time_slices=2, mode="direct")


def test_fused_stage_real_unet_matches_jax(models, tmp_path, monkeypatch):
    """The fused seg -> instance -> patch stage (pipeline/fused.py) with
    this module's U-Net: its probabilities within 1e-5 of the JAX fused
    stage's on the fused tests' 3-frame 64 x 64 site. The U-Net runs at
    batch 1 on the whole frame in both packages. The JAX stage clusters
    with the port's native grid DBSCAN (sklearn's labels exactly:
    ``test_torch_patch_track.py::test_grid_dbscan_matches_sklearn``), as
    the JAX package's own native library would: the sklearn fallback it
    takes here spent 5 s on this model's foreground, which this test does
    not compare."""
    import dynamorph_tpu.native.dbscan as jax_dbscan
    from dynamorph_tpu_torch.native.dbscan import grid_dbscan
    from test_torch_fused import SITE, T, _make_site, _run_jax_fused, \
        run_port_fused

    monkeypatch.setattr(jax_dbscan, "grid_dbscan", grid_dbscan)
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


# -- Slice H: training, metrics, multi-slice ---------------------------

FIT_LR = 1e-6


def _fit_pairs(seed, n):
    """n (raw (2, 1, 32, 32) float64, soft label (3, 1, 32, 32)) pairs; each
    patch at its own brightness, so train-mode batch norm's statistics are
    well conditioned at the bottleneck (1 x 1 at 32 x 32)."""
    r = np.random.RandomState(seed)
    raw = r.rand(n, 2, 1, WINDOW, WINDOW) * \
        r.uniform(5000, 65535, (n, 1, 1, 1, 1))
    lab = r.rand(n, 3, 1, WINDOW, WINDOW) ** 3
    lab /= lab.sum(1, keepdims=True)
    return [[x, y] for x, y in zip(raw, lab)]


def _port_copy(jm, params, state, cls=Segment, **kw):
    pm = cls(input_shape=jm.input_shape, n_classes=3, device="cpu", **kw)
    pm.net.load_state_dict(state_dict_from_jax(params, state, "UNet"),
                           strict=True)
    return pm


def _max_abs(sd):
    return max(float(v.abs().max()) for v in sd.values()
               if v.dtype.is_floating_point)


def _adam_checked(pm, checks, null=()):
    """``pm._make_step`` wrapped so that the first two train steps (the
    second is the first to read beta1 and beta2) are held to Adam
    (``optax.adam``'s 0.9, 0.999, eps 1e-8) from the port's own moments
    and gradient before and after the step: the moments follow their
    recurrences within 1e-6 of their terms, and every parameter moves by
    the bias-corrected update within half an fp32 ulp of itself plus 1e-4
    of the update (the fp32 check's own rounding is a few 1e-7 of it; the
    change ``p - p0`` of two close floats is exact). The first step's
    gradient is also held against a float64 copy of the network at the
    step's weights, on the step's batch, through the weighted
    cross-entropy written out here: within 2% of its norm a tensor (the
    fp32 train-mode batch norm of the 1 x 1 bottleneck over four values
    costs 1%). A frozen parameter's gradient must be 0; a parameter named
    in ``null`` (a bias feeding a train-mode batch norm, whose exact
    gradient is 0) must have a gradient under 1e-6 of the step's largest
    float64 gradient norm, in both precisions. Appends one record a step
    to ``checks``: its learning rate and, for the checked steps, its worst
    error against the bound and the count of parameters it moved."""
    make_step = pm._make_step

    def spy(lr):
        opt, step = make_step(lr)
        # a fixed weight (the Keras graph's bn_data gamma) is no parameter
        # of the optimizer; a frozen one has its gradient zeroed
        named = [(n, p) for n, p in pm.net.named_parameters()
                 if p.requires_grad]
        frozen = {id(p) for p in pm.net.encoder_parameters()} \
            if pm.freeze_encoder else set()
        net64 = None

        def checked(x, y):
            nonlocal net64
            t = len(checks) + 1
            if t > 2:
                checks.append({"lr": opt.param_groups[0]["lr"]})
                return step(x, y)
            if t == 1:
                net64 = copy.deepcopy(pm.net).double()
            before = [(p.detach().clone(),
                       *(opt.state[p][k].clone() if p in opt.state
                         else torch.zeros_like(p)
                         for k in ("exp_avg", "exp_avg_sq")))
                      for _, p in named]
            loss = step(x, y)
            lr_t = opt.param_groups[0]["lr"]
            worst, moved = 0.0, 0
            with torch.no_grad():
                for (name, p), (p0, m0, v0) in zip(named, before):
                    assert p in opt.state, name     # the step stepped
                    g = p.grad
                    m = 0.9 * m0 + 0.1 * g
                    v = 0.999 * v0 + 0.001 * g * g
                    assert ((opt.state[p]["exp_avg"] - m).abs() <= 1e-6 * (
                        0.9 * m0.abs() + 0.1 * g.abs())).all(), name
                    assert ((opt.state[p]["exp_avg_sq"] - v).abs()
                            <= 1e-6 * v).all(), name
                    upd = (lr_t / (1 - 0.9 ** t)) * m / (
                        (v / (1 - 0.999 ** t)).sqrt_() + 1e-8)
                    d = p - p0                  # exact: p, p0 are close
                    bound = torch.maximum(p.abs(), p0.abs()).mul_(
                        0.5 * torch.finfo(torch.float32).eps)
                    bound.add_(upd.abs(), alpha=1e-4)
                    worst = max(worst, float(
                        ((d + upd).abs_() - bound).max()))
                    moved += int(torch.count_nonzero(d))
            if t == 1:
                xs, ys = x.double(), y.double()
                logp = torch.log_softmax(net64.apply(xs, train=True), 1)
                loss64 = torch.mean(
                    -torch.sum(ys[:, :-1] * logp, 1) * ys[:, -1])
                grads = torch.autograd.grad(loss64, [
                    p for p in net64.parameters() if p.requires_grad])
                g_top = max(float(g.norm()) for g in grads)
                for (name, p), g in zip(named, grads):
                    if id(p) in frozen:
                        assert not p.grad.any(), name
                        continue
                    if name in null:
                        assert max(float(g.norm()), float(p.grad.norm())) \
                            <= 1e-6 * g_top, name
                        continue
                    rel = float((p.grad.double() - g).norm() / g.norm())
                    assert rel <= 2e-2, (name, rel)
                loss64 = float(loss64.detach())
                assert abs(float(loss) - loss64) <= 1e-5 * loss64
                net64 = None
            checks.append({"lr": lr_t, "worst": worst, "moved": moved})
            return loss

        return opt, checked

    return spy


def test_fit_matches_jax(models, tmp_path, monkeypatch):
    """``fit`` (2 epochs of 2 steps at batch 4, validation on 4 patches)
    against the JAX package's on the module's weights: history losses
    within 1e-4 relative; each parameter's change over the fit within 30%
    of the JAX package's change to it (a tensor's norm), and moved; the
    final parameters within 1e-4 of the model's largest magnitude (its
    batch-norm running statistics within 2e-3); the same checkpoint
    names; and ROC-AUC / F1 within 1e-12 of sklearn's on the port's own
    validation logits. The port's first two steps are held to Adam and
    its first gradient to a float64 network (``_adam_checked``).

    Both fits run at lr 1e-6 (``_lr``). At the default 1e-3 the two fp32
    steps part: Adam moves every weight by about lr whatever the size of
    its gradient, so a gradient whose sign rounding decides moves a weight
    2e-3 apart a step (1e-5 still moves the stem's kernels, bound 0.08,
    by 0.1% apart over 4 steps, and layer1's batch means with them); and
    the JAX package's one-pass batch-norm variance cancels at these shapes
    (its train-step gradients are 10-25% from a float64 step in the deep
    encoder, the port's within 2%). Over four steps Adam's ratio of
    moments turns a gradient's few percent into up to 17% of a change
    (the port's fp32 fit against its own float64 replay, 24% against the
    JAX package's), hence 30% on the changes and the exact per-step check
    beside it. Batch 4, not 2: at batch 2 the 1 x 1 bottleneck normalises
    two values a channel, where the JAX variance is mostly rounding."""
    from sklearn.metrics import f1_score, roc_auc_score

    from dynamorph_tpu.seg import model as jax_model

    jm, _ = models
    saved = []
    monkeypatch.setattr(jax_model, "save_checkpoint",
                        lambda path, tree: saved.append(
                            os.path.basename(path)))
    params_m, state0 = jm.params, jm.state
    # the JAX init's head (the module scales it by 10 for O(1) logits; the
    # loss of that steep model moves 1e-3 a step at lr 1e-6)
    params0 = dict(params_m, head=dict(
        params_m["head"], kernel=params_m["head"]["kernel"] / 10))
    train, valid = _fit_pairs(20, 8), _fit_pairs(21, 4)
    pm = _port_copy(jm, params0, state0, model_path=str(tmp_path / "port"))
    jm.params, jm._lr = params0, FIT_LR
    pm._lr = FIT_LR
    try:
        hj = jm.fit(train, batch_size=4, n_epochs=2, valid_patches=valid)
        params1, state1 = jax.device_get((jm.params, jm.state))
    finally:
        jm.params, jm.state, jm._lr = params_m, state0, 1e-3
    checks = []
    monkeypatch.setattr(pm, "_make_step", _adam_checked(pm, checks))
    hp = pm.fit(train, batch_size=4, n_epochs=2, valid_patches=valid)
    assert [c["lr"] for c in checks] == [FIT_LR] * 4
    assert all(c["worst"] <= 0 and c["moved"] > 0 for c in checks[:2]), \
        checks
    assert [h["epoch"] for h in hp] == [h["epoch"] for h in hj] == [0, 1]
    for a, b in zip(hp, hj):
        for k in ("loss", "val_loss"):
            assert abs(a[k] - b[k]) <= 1e-4 * abs(b[k]), (k, a[k], b[k])
    assert sorted(os.listdir(tmp_path / "port")) == saved == [
        "weights.%02d-%.2f" % (h["epoch"], h["val_loss"]) for h in hj]
    want = state_dict_from_jax(params1, state1, "UNet")
    start = state_dict_from_jax(params0, state0, "UNet")
    got = pm.net.state_dict()
    top = _max_abs(want)
    for k, v in want.items():
        if not v.dtype.is_floating_point:
            continue
        # the running statistics carry the JAX package's one-pass
        # variance, 1e-3 of the largest magnitude after 4 steps
        tol = (2e-3 if "running" in k else 1e-4) * top
        assert float((got[k] - v).abs().max()) <= tol, k
        if "running" not in k:
            d_jax = v.double() - start[k].double()
            d_port = got[k].double() - start[k].double()
            assert float(d_port.norm()) > 0, k
            assert float((d_port - d_jax).norm()) <= \
                0.3 * float(d_jax.norm()), k
    # each checkpoint loads strict and is that epoch's model
    ck = Segment(input_shape=(2, WINDOW, WINDOW), device="cpu")
    ck.load(str(tmp_path / "port" / saved[-1]))
    for k, v in ck.net.state_dict().items():
        assert torch.equal(v, got[k]), k
    # the metrics against sklearn on the port's own validation logits
    X, y = pm._arrays(valid, "prob")
    with torch.no_grad():
        logits = pm.net.apply(torch.from_numpy(X), train=False)[:, 0]
    truth = (y[:, 0] > 0.5).reshape(-1)
    pred = logits.numpy().reshape(-1)
    rec = pm._validate((X, y))
    assert abs(rec["val_roc_auc"] - roc_auc_score(truth, pred)) <= 1e-12
    assert abs(rec["val_f1"] - f1_score(truth, pred > 0.5)) <= 1e-12
    assert rec["val_loss"] == hp[-1]["val_loss"]


@pytest.mark.parametrize("case", ["ties", "no_ties", "one_sided", "floats"])
def test_metrics_match_sklearn(case):
    """``seg/metrics.py`` against sklearn within 1e-12: tied scores (the
    ROC collapses ties), distinct scores, no prediction over 0.5 (F1 0),
    and float32 scores as the validation logits are."""
    from sklearn.metrics import f1_score as sk_f1
    from sklearn.metrics import roc_auc_score as sk_auc

    from dynamorph_tpu_torch.seg.metrics import f1_score, roc_auc_score

    r = np.random.RandomState(30)
    truth = r.rand(5000) > 0.6
    score = {"ties": r.randint(0, 7, 5000) / 6.0,
             "no_ties": r.permutation(5000) / 5000.0 + truth * 0.2,
             "one_sided": r.rand(5000) * 0.5,
             "floats": (r.randn(5000) + truth).astype(np.float32)}[case]
    t, s = torch.from_numpy(truth), torch.from_numpy(score)
    assert abs(roc_auc_score(t, s) - sk_auc(truth, score)) <= 1e-12
    assert abs(f1_score(t, s > 0.5) - sk_f1(truth, score > 0.5)) <= 1e-12
    with pytest.raises(ValueError):
        roc_auc_score(torch.ones(4, dtype=torch.bool), torch.rand(4))


def test_freeze_encoder_trains_decoder_and_encoder_statistics(models,
                                                               tmp_path):
    """``freeze_encoder``: the encoder's weights stay, its batch-norm
    running statistics still move (train mode, as in the JAX step), and
    the rest trains."""
    jm, _ = models
    pm = _port_copy(jm, jm.params, jm.state, freeze_encoder=True,
                    model_path=str(tmp_path))
    before = {k: v.clone() for k, v in pm.net.state_dict().items()}
    pm.fit(_fit_pairs(22, 4), batch_size=4, n_epochs=1)
    after = pm.net.state_dict()
    assert not os.listdir(tmp_path)         # no validation, no checkpoint
    for k, v in after.items():
        changed = not torch.equal(v, before[k])
        if k.startswith("encoder.") and ("running" in k
                                         or "num_batches" in k):
            assert changed, k
        elif k.startswith("encoder."):
            assert not changed, k
        elif not k.endswith("num_batches_tracked") and "running" not in k:
            assert changed, k


def test_encoder_weights_from_torchvision_dict(models):
    """``encoder_weights``: a seeded torchvision-format resnet34 state_dict
    (``fc.*`` included) lands on ``encoder.*`` as the JAX package's
    ``import_resnet34_encoder`` puts it, the rest stays at its init; a dict
    without an encoder tensor is refused."""
    from dynamorph_tpu_torch.models.unet import ResNet34Encoder

    jm, _ = models
    torch.manual_seed(31)
    tv = {k: torch.randn(v.shape) if v.dtype.is_floating_point else v
          for k, v in ResNet34Encoder().state_dict().items()}
    tv["fc.weight"], tv["fc.bias"] = torch.randn(1000, 512), torch.zeros(1000)
    pm = Segment(input_shape=(2, WINDOW, WINDOW), device="cpu", seed=3,
                 encoder_weights=tv)
    ref = Segment(input_shape=(2, WINDOW, WINDOW), device="cpu", seed=3)
    jx = _bare_jax_segment(JaxSegment, (2, WINDOW, WINDOW), seed=4)
    jx._load_encoder_weights({k: v.numpy() for k, v in tv.items()})
    want = state_dict_from_jax(*jax.device_get((jx.params, jx.state)),
                               "UNet")
    for k, v in pm.net.state_dict().items():
        if k.startswith("encoder.") and not k.endswith("num_batches_tracked"):
            assert torch.equal(v, tv[k[len("encoder."):]]), k
            assert torch.equal(v, want[k]), k
        elif not k.startswith("encoder."):
            assert torch.equal(v, ref.net.state_dict()[k]), k
    del tv["layer4.2.bn2.running_var"]
    with pytest.raises(ValueError, match="lacks 1 resnet34"):
        Segment(input_shape=(2, WINDOW, WINDOW), device="cpu",
                encoder_weights=tv)


class _PixelLogits(torch.nn.Module):
    """Three logits a pixel from a 1 x 1 convolution, with the U-Net's
    ``apply(x, train)``."""

    def __init__(self):
        super().__init__()
        torch.manual_seed(0)
        self.conv = torch.nn.Conv2d(2, 3, 1)

    def apply(self, x, train=False):
        return self.conv(x)


def test_reduce_lr_on_plateau_lowers_lr_in_place(tmp_path, monkeypatch):
    """ReduceLROnPlateau(patience=5): on a stub validation whose loss never
    improves after epoch 0, the rate drops to 1e-4 after epoch 5 and to
    1e-5 after epoch 10, in the same Adam (its step count runs on), and a
    NaN loss ends the fit with the epochs so far. The schedule does not
    read the network, so a 1 x 1 convolution stands in for the U-Net
    (whose steps ``test_fit_matches_jax`` holds): twelve U-Net steps
    would take 4 s."""
    pm = Segment(input_shape=(2, WINDOW, WINDOW), device="cpu",
                 model_path=str(tmp_path))
    pm.net = _PixelLogits()
    seen = []
    make_step = pm._make_step

    def spy(lr):
        opt, step = make_step(lr)
        seen.append(opt)
        return opt, step

    lrs = []
    monkeypatch.setattr(pm, "_make_step", spy)
    monkeypatch.setattr(pm, "_validate", lambda v: (
        lrs.append(seen[0].param_groups[0]["lr"]),
        {"val_loss": 1.0, "val_roc_auc": 0.5, "val_f1": 0.0})[1])
    pairs = _fit_pairs(23, 2)
    hist = pm.fit(pairs, batch_size=2, n_epochs=12, valid_patches=pairs)
    assert len(hist) == 12 and len(seen) == 1
    assert lrs == [1e-3] * 6 + [pytest.approx(1e-4)] * 5 + \
        [pytest.approx(1e-5)]
    assert seen[0].param_groups[0]["lr"] == pytest.approx(1e-5)
    steps = {int(s["step"]) for s in seen[0].state.values()}
    assert steps == {12}
    monkeypatch.setattr(pm, "_validate", lambda v: {
        "val_loss": float("nan"), "val_roc_auc": 0.5, "val_f1": 0.0})
    bad = [[x * np.nan, y] for x, y in pairs]
    assert pm.fit(bad, batch_size=2, n_epochs=3) == []


@pytest.fixture(scope="module")
def multislice(models):
    """(JAX SegmentWithMultipleSlice, the port's) at unet_feat 8 and input
    (2, 2, 32, 32): the module's U-Net body with a head to 8 features and
    seeded 1x1 post_conv / pred_head."""
    from dynamorph_tpu.seg.model import SegmentWithMultipleSlice as JaxMS

    jm, _ = models
    js = _bare_jax_segment(JaxMS, (2, 2, WINDOW, WINDOW), unet_feat=8)
    r = np.random.RandomState(32)
    params = dict(jm.params)
    params["head"] = {
        "kernel": (r.randn(3, 3, 16, 8) * 0.3).astype(np.float32),
        "bias": (0.1 * r.randn(8)).astype(np.float32)}
    params["post_conv"] = {
        "kernel": (r.randn(1, 1, 16, 8) * 0.5).astype(np.float32),
        "bias": (0.1 * r.randn(8)).astype(np.float32)}
    params["pred_head"] = {
        "kernel": (r.randn(1, 1, 8, 3) * 2).astype(np.float32),
        "bias": (0.1 * r.randn(3)).astype(np.float32)}
    js.params, js.state = jax.device_put(params), jm.state
    ps = SegmentWithMultipleSlice(unet_feat=8,
                                  input_shape=(2, 2, WINDOW, WINDOW),
                                  device="cpu")
    ps.net.load_state_dict(state_dict_from_jax(params, jm.state, "UNet"),
                           strict=True)
    return js, ps


def test_multislice_predict_matches_jax(multislice):
    """``SegmentWithMultipleSlice``: the probabilities of 8 tiles of (2
    channels, 2 slices) against the JAX package's tile program, and
    ``predict`` on patch pairs the same."""
    from dynamorph_tpu.seg.inference import _scaled_predict_fn

    js, ps = multislice
    raw = np.random.RandomState(33).rand(8, 2, 2, WINDOW, WINDOW) * 65535
    want = np.asarray(_scaled_predict_fn(js)(
        js.params, js.state, raw.astype(np.float32)))
    got = ps.predict_raw(raw.astype(np.float32))
    assert got.shape == want.shape == (8, 3, 1, WINDOW, WINDOW)
    np.testing.assert_allclose(got, want, atol=PROB_ATOL, rtol=0)
    assert np.ptp(want) > 0.1
    pairs = [[x, None] for x in raw[:2]]
    np.testing.assert_allclose(ps.predict(pairs, label_input=None), got[:2],
                               atol=1e-6, rtol=0)


def test_predict_whole_map_time_slices_matches_jax(multislice):
    """``predict_whole_map(time_slices=2)``: 3 frames give 2, each from
    itself and the next frame on the z axis, in the tiled mode with the
    JAX package's offsets; within 1e-5 of the JAX package's."""
    js, ps = multislice
    stack = _stack(34, n_channels=2)
    stack = np.concatenate([stack, stack[:1] * 0.5])        # 3 frames
    rj, rt = _Recorder(1), _Recorder(1)
    pj = jax_whole_map(stack, js, n_supp=1, time_slices=2, rng=rj)
    pt = predict_whole_map(stack, ps, n_supp=1, time_slices=2, rng=rt)
    assert rt.draws == rj.draws
    assert pt.shape == pj.shape == (2, 3, 1, 64, 64)
    np.testing.assert_allclose(pt, pj, atol=PROB_ATOL, rtol=0)


def test_run_segmentation_time_slices(multislice, tmp_path):
    """``run_segmentation -m segmentation`` with ``time_slices: 2`` builds
    the multi-slice model from ``unet_feat`` and writes what
    ``predict_whole_map`` gives for it."""
    _, ps = multislice
    raw = tmp_path / "raw"
    raw.mkdir()
    stack = _stack(35, n_channels=2)
    np.save(raw / "B2-Site_0.npy", stack)
    ps.save(str(tmp_path / "w"))
    yml = tmp_path / "cfg.yml"
    yml.write_text(
        "segmentation_inference:\n"
        f"  raw_dirs: ['{raw}']\n  supp_dirs: ['{tmp_path}']\n"
        f"  weights: '{tmp_path / 'w'}'\n  channels: [0, 1]\n"
        f"  window_size: {WINDOW}\n  num_pred_rnd: 1\n"
        "  time_slices: 2\n  unet_feat: 8\n")
    np.random.seed(5)
    run_segmentation.main(["-m", "segmentation", "-c", str(yml),
                           "--device", "cpu"])
    got = np.load(raw / "B2-Site_0_NNProbabilities.npy")
    np.random.seed(5)
    want = predict_whole_map(stack, ps, n_supp=1, time_slices=2)
    assert got.shape == (1, 3, 1, 64, 64)
    np.testing.assert_array_equal(got, want)
