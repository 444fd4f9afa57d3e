"""The port's work after the latents (``reduce/cpca.py``, ``analysis/``,
``train/data.py::prepare_dataset_from_collection`` and ``convert_storage
--delete-source``) against the JAX package, on the CPU.

Tolerances, with their reasons:

- cPCA: an eigenvector is defined up to its sign, and only where its
  eigenvalue stands clear of its neighbours. Where the float64 gap to the
  next eigenvalue is at least 1e-3 of the largest |w|, each component
  (sign-aligned) has |cos| >= 1 - 1e-4 to JAX's and its projection lies
  within 1e-4 of the largest |projection|; inside a closer cluster any
  basis is an answer, so there only the Rayleigh quotient is held (in
  float64, within 1e-5 of the largest |w| of the eigenvalue of its rank).
  The covariances equal numpy's float64 within 1e-12 relative.
- The MSD functions, the short-trajectory collections,
  ``trajectory_summaries`` and ``well_conditioned_gmm`` are host numpy
  copied from the JAX package: bit-equal.
- k-means (the port's own, sklearn's algorithm but not its random stream)
  against sklearn's ``KMeans(n_init=10)``: labels equal up to a
  permutation on separated clusters, inertia at most 1.0001 x sklearn's.
  The state-clustering functions on the JAX tests' own fixtures: state
  membership equal up to the names' permutation.
- Reconstruction losses, per sample, within 1e-5 relative (fp32
  convolution order, XLA-CPU vs oneDNN; no code flips on these inputs).
- PNGs decode (cv2) equal to the JAX package's.
- ``prepare_dataset_from_collection``: bit-equal at an integer factor, and
  within 2.5e-6 of the largest magnitude at a non-integer one (the port's
  one-channel bilinear against cv2's).
"""
import os
import pickle

import cv2
import numpy as np
import pytest
import torch

import jax

from dynamorph_tpu.analysis import pc_samples as jax_pc
from dynamorph_tpu.analysis import recon_eval as jax_recon
from dynamorph_tpu.analysis import state_clustering as jax_sc
from dynamorph_tpu.analysis import trajectory_dynamics as jax_td
from dynamorph_tpu.cli import convert_storage as jax_convert
from dynamorph_tpu.models import VQVAEz16 as JaxZ16
from dynamorph_tpu.models import vae as jvae
from dynamorph_tpu.reduce import cpca as jax_cpca
from dynamorph_tpu.train import data as jax_data
from dynamorph_tpu_torch.analysis import (pc_samples, recon_eval,
                                          state_clustering, trajectory_dynamics)
from dynamorph_tpu_torch.analysis.kmeans import kmeans
from dynamorph_tpu_torch.cli import convert_storage
from dynamorph_tpu_torch.io.pickles import save_pickle
from dynamorph_tpu_torch.models import AAEModel, VQVAEz16
from dynamorph_tpu_torch.models.jax_import import state_dict_from_jax
from dynamorph_tpu_torch.reduce import cpca
from dynamorph_tpu_torch.train import data as port_data
from test_state_gmm import _two_state_data
from test_torch_vae_family import numpy_weights
from test_torch_train import _few_threads  # noqa: F401

GAP_REL = 1e-3
COS_TOL = 1e-4


# ------------------------------------------------------------------ cPCA


def _cpca_sets(r, n=600, d=12):
    background = r.randn(n, d) * 0.1
    background[:, 0] += r.randn(n) * 5.0
    target = r.randn(n, d) * 0.1
    target[:, 0] += r.randn(n) * 5.0
    target[:, 1] += r.randn(n) * 1.5
    target[:, 2] += r.randn(n) * 0.7
    return target.astype(np.float32), background.astype(np.float32)


@pytest.mark.parametrize("alphas", [tuple(jax_cpca.auto_alphas()),
                                    (0.0, 1.0, 10.0, 100.0)],
                         ids=["auto_alphas", "defaults"])
def test_cpca_matches_jax(alphas):
    target, background = _cpca_sets(np.random.RandomState(0))
    k = 3
    ours = cpca.fit_cpca(target, background, n_components=k, alphas=alphas,
                         device="cpu")
    theirs = jax_cpca.fit_cpca(target, background, n_components=k,
                               alphas=alphas)
    c_t, c_b = cpca.covariances(target, background, "cpu")
    for got, want in ((c_t, jax_cpca._cov(target.astype(np.float64))),
                      (c_b, jax_cpca._cov(background.astype(np.float64)))):
        got = got.numpy()
        assert np.linalg.norm(got - want) <= 1e-12 * np.linalg.norm(want)
    held = 0
    for (a, comp, proj), (ja, jcomp, jproj) in zip(ours, theirs):
        assert a == ja and comp.shape == jcomp.shape == (k, 12)
        assert comp.dtype == np.float32 and proj.shape == jproj.shape
        m = jax_cpca._cov(target.astype(np.float64)) - a * jax_cpca._cov(
            background.astype(np.float64))
        w = np.linalg.eigvalsh(m)[::-1]
        scale = np.abs(w).max()
        for i in range(k):
            gap = min(w[i - 1] - w[i] if i else np.inf, w[i] - w[i + 1])
            rayleigh = comp[i].astype(np.float64) @ m @ comp[i]
            assert abs(rayleigh - w[i]) <= 1e-5 * scale, (a, i)
            if gap < GAP_REL * scale:
                continue
            cos = float(comp[i] @ jcomp[i])
            assert abs(cos) >= 1 - COS_TOL, (a, i, cos)
            sign = np.sign(cos)
            np.testing.assert_allclose(
                proj[:, i], sign * jproj[:, i], rtol=0,
                atol=1e-4 * np.abs(jproj[:, i]).max())
            held += 1
    assert held >= len(alphas) * 2
    assert np.array_equal(cpca.auto_alphas(), jax_cpca.auto_alphas())


# ------------------------------------------------- trajectory dynamics


def _walks(r, n_traj=6, n=18, gaps=True):
    out = []
    for i in range(n_traj):
        pos = np.cumsum(r.randn(n, 2) * (0.5 + i), axis=0)
        ts = [t for t in range(n) if not (gaps and i % 2 and t in (5, 11))]
        out.append({t: pos[t] for t in ts})
    return out


def test_msd_and_short_trajectories_bit_equal():
    trajs = _walks(np.random.RandomState(1))
    for max_lag in (14, 4):
        ours = trajectory_dynamics.generate_msd_distri(trajs, max_lag)
        assert ours == jax_td.generate_msd_distri(trajs, max_lag)
        pts = trajectory_dynamics.msd_curve(trajs, max_lag)
        assert np.array_equal(pts, jax_td.msd_curve(trajs, max_lag))
    for n, icpt in ((5, False), (5, True), (9, False)):
        assert trajectory_dynamics.fit_msd_powerlaw(pts, n, icpt) == \
            jax_td.fit_msd_powerlaw(pts, n, icpt)
    for length, raw in ((5, False), (5, True), (3, False)):
        ours = trajectory_dynamics.generate_short_traj_collections(
            trajs, length, raw)
        theirs = jax_td.generate_short_traj_collections(trajs, length, raw)
        assert len(ours) == len(theirs) > 0
        for a, b in zip(ours, theirs):
            assert np.array_equal(np.asarray(a), np.asarray(b))
    assert trajectory_dynamics.msd_curve([{0: (0, 0)}]).shape == (0, 2)


def test_plot_msd_imports_matplotlib_in_the_call(tmp_path):
    pytest.importorskip("matplotlib")
    trajs = _walks(np.random.RandomState(2), gaps=False)
    path = str(tmp_path / "msd.png")
    pts = trajectory_dynamics.plot_msd(trajs, path)
    assert os.path.getsize(path) > 0
    assert np.array_equal(pts, jax_td.msd_curve(trajs))


# ------------------------------------------------------ state clustering


def test_summaries_and_gmm_bit_equal(rng):
    """On test_state_gmm.py's fixture: the features and every output of the
    EM."""
    pcs, ti, tp, conds = _two_state_data(rng)
    for t_lag in (1, 3):
        ours = state_clustering.trajectory_summaries(ti, tp, pcs, t_lag=t_lag)
        theirs = jax_sc.trajectory_summaries(ti, tp, pcs, t_lag=t_lag)
        assert all(np.array_equal(a, b) for a, b in zip(ours, theirs))
    X, _ = ours
    init = np.stack([np.median(X[conds == 0], 0),
                     np.median(X[conds == 1], 0)])
    ours = state_clustering.well_conditioned_gmm(X, conds, init, n_iter=30)
    theirs = jax_sc.well_conditioned_gmm(X, conds, init, n_iter=30)
    assert set(ours) == set(theirs)
    for k in ours:
        assert np.array_equal(ours[k], theirs[k]), k


def _blobs(seed, n_per, k, d, dtype):
    r = np.random.RandomState(seed)
    centers = r.randn(k, d) * 8
    x = np.concatenate([c + r.randn(n_per, d) for c in centers])
    return x[r.permutation(len(x))].astype(dtype)


def _same_partition(a, b):
    """Labels equal up to a permutation of the names."""
    pairs = set(zip(np.asarray(a).tolist(), np.asarray(b).tolist()))
    return len(pairs) == len(set(a.tolist())) == len(set(b.tolist()))


@pytest.mark.parametrize("seed,k,dtype", [(0, 3, np.float64),
                                          (1, 5, np.float64),
                                          (2, 4, np.float32),
                                          (3, 8, np.float32)])
def test_kmeans_matches_sklearn_on_separated_clusters(seed, k, dtype):
    from sklearn.cluster import KMeans

    x = _blobs(seed, 60, k, 6, dtype)
    ours = kmeans(x, k, seed=seed, device="cpu")
    sk = KMeans(n_clusters=k, random_state=seed, n_init=10).fit(x)
    assert ours.labels_.shape == (len(x),) and ours.labels_.dtype == np.int32
    assert _same_partition(ours.labels_, sk.labels_)
    assert ours.inertia_ <= 1.0001 * sk.inertia_
    assert ours.cluster_centers_.shape == (k, 6)
    again = kmeans(x, k, seed=seed, device="cpu")
    assert np.array_equal(again.labels_, ours.labels_)


def test_kmeans_refuses_fewer_samples_than_clusters():
    with pytest.raises(ValueError):
        kmeans(np.zeros((2, 3)), 3, device="cpu")


def test_kmeans_on_short_trajs_matches_jax(rng):
    """test_state_clustering.py's fixture: two descriptor regimes; raw
    windows separate them, and their diffs have JAX's shape."""
    vs = np.concatenate([rng.randn(30, 4) + 10, rng.randn(30, 4) - 10])
    trajs = [list(range(0, 30)), list(range(30, 60))]
    km, feats, labels = state_clustering.kmeans_on_short_trajs(
        vs, trajs, length=3, n_clusters=2, device="cpu")
    jkm, jfeats, jlabels = jax_sc.kmeans_on_short_trajs(
        vs, trajs, length=3, n_clusters=2)
    assert np.array_equal(feats, jfeats)
    assert _same_partition(labels, jlabels)
    assert km.inertia_ <= 1.0001 * jkm.inertia_
    _, feats_d, labels_d = state_clustering.kmeans_on_short_trajs(
        vs, trajs, length=3, n_clusters=2, diffs=True, device="cpu")
    _, jfeats_d, _ = jax_sc.kmeans_on_short_trajs(
        vs, trajs, length=3, n_clusters=2, diffs=True)
    assert np.array_equal(feats_d, jfeats_d)
    assert labels_d.shape == (len(feats_d),)


@pytest.mark.parametrize("scales", [(0.01, 1.0, 20.0),
                                    (0.01, 0.5, 2.0, 40.0)],
                         ids=["three", "four"])
def test_movement_state_clustering_matches_jax(rng, scales):
    """test_state_clustering.py's fixtures (5 walks of each scale with three
    states, 4 with four): the same trajectories in each state."""
    per = 5 if len(scales) == 3 else 4

    def walk(scale, n=20):
        pos = np.cumsum(rng.randn(n, 2) * scale, axis=0)
        return {t: pos[t] for t in range(n)}

    trajs = [walk(s) for s in scales for _ in range(per)]
    ours = state_clustering.movement_state_clustering(
        trajs, length=5, n_clusters=len(scales), device="cpu")
    theirs = jax_sc.movement_state_clustering(trajs, length=5,
                                              n_clusters=len(scales))
    assert set(ours) == set(theirs)
    assert {frozenset(v) for v in ours.values()} == \
        {frozenset(v) for v in theirs.values()}


# ---------------------------------------------------- recon evaluation


@pytest.mark.parametrize("network", ["VQ_VAE_z16", "AAE"])
def test_recon_losses_match_jax(network):
    kw = dict(num_hiddens=8, num_residual_hiddens=8)
    if network == "AAE":
        jmodel, model = jvae.AAEModel(**kw), AAEModel(**kw)
    else:
        kw["num_embeddings"] = 16
        jmodel = JaxZ16(vq_impl="xla", **kw)
        model = VQVAEz16(**kw)
    params, state = numpy_weights(jmodel, seed=9)
    model.load_state_dict(state_dict_from_jax(params, state, network),
                          strict=True)
    data = np.random.RandomState(10).rand(40, 2, 64, 64).astype(np.float32)
    ours = recon_eval.evaluate_recon_losses(model, data, n_samples=20,
                                            seed=1, batch_size=8,
                                            device="cpu")
    theirs = jax_recon.evaluate_recon_losses(
        jmodel, jax.tree_util.tree_map(np.asarray, params), state, data,
        n_samples=20, seed=1, batch_size=8)
    assert ours.shape == theirs.shape == (20,)
    np.testing.assert_allclose(ours, theirs, rtol=1e-5, atol=0)
    assert recon_eval.recon_loss_summary(ours) == \
        jax_recon.recon_loss_summary(ours)


# ----------------------------------------------------- PC-sample montages


def test_pc_sample_montage_pngs_decode_equal(tmp_path):
    r = np.random.RandomState(11)
    patches = r.rand(53, 2, 24, 24).astype(np.float32) * 1.2 - 0.1
    pcs = r.randn(53)
    for mod, out in ((pc_samples, "ours"), (jax_pc, "theirs")):
        mod.pc_sample_montage(patches, pcs, str(tmp_path / out),
                              pc_name="PC1", n_buckets=4, n_samples=7,
                              channel=1, seed=3)
    names = sorted(os.listdir(tmp_path / "theirs"))
    assert names == sorted(os.listdir(tmp_path / "ours")) and len(names) == 8
    for n in names:
        a = cv2.imread(str(tmp_path / "ours" / n), cv2.IMREAD_UNCHANGED)
        b = cv2.imread(str(tmp_path / "theirs" / n), cv2.IMREAD_UNCHANGED)
        assert a.dtype == b.dtype == np.uint16 and np.array_equal(a, b), n
    for i in range(4):
        assert np.array_equal(pc_samples.quantile_buckets(pcs, 4)[i],
                              jax_pc.quantile_buckets(pcs, 4)[i])
    assert np.array_equal(pc_samples.enhance_contrast(patches * 60000),
                          jax_pc.enhance_contrast(patches * 60000))


# ---------------------------------------- deprecated patch collections


@pytest.mark.parametrize("shape,exact", [((32, 32), True),
                                         ((48, 48), False)],
                         ids=["integer-factor", "non-integer"])
def test_prepare_dataset_from_collection_matches_jax(tmp_path, shape, exact):
    r = np.random.RandomState(12)
    fs = []
    for site in ("D5-Site_0", "D5-Site_1"):
        coll = {}
        for i in range(3):
            name = f"/data/{site}/{i}"
            coll[name] = {"masked_mat": np.round(
                r.rand(3, 1, 64, 64) * 65535) / 2}
            fs.append(name)
        with open(tmp_path / f"{site}_all_patches.pkl", "wb") as fh:
            pickle.dump(coll, fh)
    fs = fs[::-1]
    ours = port_data.prepare_dataset_from_collection(
        fs, cs=[0, 2], input_shape=shape, file_path=str(tmp_path))
    theirs = jax_data.prepare_dataset_from_collection(
        fs, cs=[0, 2], input_shape=shape, file_path=str(tmp_path))
    assert ours.shape == theirs.shape == (6, 2, 1) + shape
    if exact:
        assert np.array_equal(ours, theirs)
    else:
        err = np.abs(ours - theirs).max()
        assert 0 < err <= 2.5e-6 * np.abs(theirs).max()


# ------------------------------------------ convert_storage --delete-source


def test_convert_storage_delete_source_matches_jax(tmp_path):
    """The same sources go, the same files are left; a source whose
    conversion raised stays, and the exit code is 1 in both."""
    r = np.random.RandomState(13)
    trees = {}
    for side in ("ours", "theirs"):
        root = tmp_path / side / "C5"
        save_pickle(r.rand(5, 8).astype(np.float32),
                    str(root / "C5_latent_space.pkl"))
        save_pickle(r.rand(5, 8).astype(np.float32),
                    str(root / "C5_latent_space_after.pkl"))
        save_pickle({"a": 1}, str(root / "C5_relations.pkl"))
        (root / "D5_latent_space.pkl").write_bytes(b"not a pickle")
        trees[side] = root
    rc_ours = convert_storage.main(["--to", "compact", str(trees["ours"]),
                                    "--delete-source"])
    rc_theirs = jax_convert.main(["--to", "compact", str(trees["theirs"]),
                                  "--delete-source"])
    assert rc_ours == rc_theirs == 1
    left = sorted(os.listdir(trees["ours"]))
    assert left == sorted(os.listdir(trees["theirs"]))
    assert "C5_latent_space.pkl" not in left and "D5_latent_space.pkl" in left
    assert "C5_latent_space.npz" in left and "C5_relations.pkl" in left


# -- Slice H: morphology, validation contours, trajectory GIFs ----------

def _morph_masks():
    """A 20 x 10 rectangle (the JAX tests' mask), seeded ellipses at
    several angles, one with a hole and a second component; as float64,
    uint8 and bool-valued float32 masks."""
    yield np.pad(np.ones((20, 10)), ((20, 24), (25, 29)))
    r = np.random.RandomState(50)
    yy, xx = np.mgrid[:72, :80]
    for i in range(5):
        t, a = r.rand() * np.pi, 8 + 18 * r.rand()
        b = a * (0.3 + 0.6 * r.rand())
        u = (yy - 36) * np.cos(t) + (xx - 40) * np.sin(t)
        v = -(yy - 36) * np.sin(t) + (xx - 40) * np.cos(t)
        d = (u / a) ** 2 + (v / b) ** 2
        m = d < 1
        if i == 3:
            m &= d > 0.1
            m[2:5, 2:9] = True
        yield m.astype([np.float64, np.uint8, np.float32][i % 3])


def test_morphology_matches_jax():
    """``get_size``, ``get_aspect_ratio_no_rotation``, ``get_angle_apr``
    (its rotation through the port's float64 warp), ``rotate_bound`` and
    ``get_intensity_profile`` equal to the JAX package's, which reads cv2;
    KAZE raises, naming the JAX package."""
    from dynamorph_tpu.analysis import morphology as jax_morph
    from dynamorph_tpu_torch.analysis import morphology as port_morph

    r = np.random.RandomState(51)
    for mask in _morph_masks():
        assert port_morph.get_size(mask) == jax_morph.get_size(mask)
        assert port_morph.get_aspect_ratio_no_rotation(mask) == \
            jax_morph.get_aspect_ratio_no_rotation(mask)
        assert port_morph.get_angle_apr(mask) == \
            jax_morph.get_angle_apr(mask)
        for angle in (17.5, -63.0):
            got = port_morph.rotate_bound(mask, angle)
            want = jax_morph.rotate_bound(mask, angle)
            assert got.dtype == want.dtype and got.shape == want.shape
            assert np.abs(got.astype(float) - want).max() <= 1e-9
        dat = [r.rand(*mask.shape) * 65535 for _ in range(2)]
        for m in (mask.astype(bool), None):
            assert repr(port_morph.get_intensity_profile(dat, m)) == \
                repr(jax_morph.get_intensity_profile(dat, m))
    # KAZE finds nothing on a flat patch: each slice's row is the JAX
    # function's float64 zero padding (analysis/kaze.py; the detector is
    # held to cv2's KAZE in test_torch_kaze_oracle.py on the card machine)
    flat = port_morph.extract_features(np.zeros((2, 32, 32)), device="cpu")
    assert flat.dtype == np.float64
    np.testing.assert_array_equal(flat, np.zeros((2, 32 * 64)))


def _validation_inputs(root, seg_png):
    """A two-site-free validation layout: a float64 (3, 2, 1, 96, 80)
    stack and one ``segmentation_<t>.png`` per frame (the same file for
    both packages: they write different instance maps)."""
    raw_dir, supp_dir = root / "raw", root / "supp"
    seg_dir = supp_dir / "B4-supps" / "B4-Site_0"
    seg_dir.mkdir(parents=True)
    raw_dir.mkdir()
    stack = np.random.RandomState(52).rand(3, 2, 1, 96, 80) * 4000 - 500
    np.save(raw_dir / "B4-Site_0.npy", stack)
    for t in range(3):
        with open(seg_dir / f"segmentation_{t}.png", "wb") as f:
            f.write(seg_png)
    return raw_dir, supp_dir


@pytest.mark.parametrize("writer", ["cv2_gray", "cv2_bgr", "port_bgr"])
def test_validation_contours_and_tiff_match_jax(writer, tmp_path):
    """``segmentation_validation_contours`` (resized 96 x 80 -> 61 x 47,
    a non-integer factor: uint8 bilinear for the frame, nearest for the
    map) and ``validation_pngs_to_tiff``: every overlay PNG decodes equal
    to the JAX package's, the TIFF is byte-equal; the instance map as a
    gray PNG and as a color one (read as gray, libpng's weights)."""
    from dynamorph_tpu.pipeline import segmentation as jax_seg
    from dynamorph_tpu_torch.io.png import write_png
    from dynamorph_tpu_torch.pipeline import segmentation as port_seg

    r = np.random.RandomState(53)
    lab = np.zeros((96, 80, 3), np.uint8)
    yy, xx = np.mgrid[:96, :80]
    for cy, cx, rad in ((30, 20, 12), (60, 50, 17), (80, 10, 9)):
        lab[(yy - cy) ** 2 + (xx - cx) ** 2 < rad ** 2] = r.randint(
            0, 256, 3)
    img = lab[..., 0] if writer == "cv2_gray" else lab
    src = tmp_path / "map.png"
    (write_png if writer == "port_bgr" else cv2.imwrite)(str(src), img)
    seg_png = src.read_bytes()
    outs = {}
    for pkg, mod in (("jax", jax_seg), ("port", port_seg)):
        raw, supp = _validation_inputs(tmp_path / pkg, seg_png)
        val = tmp_path / pkg / "val"
        mod.segmentation_validation_contours(str(raw), str(supp), str(val),
                                             ["B4-Site_0"],
                                             out_size=(61, 47))
        outs[pkg] = (val, mod.validation_pngs_to_tiff(str(val),
                                                      "B4-Site_0"))
    for t in range(3):
        got = cv2.imread(str(outs["port"][0] / f"B4-Site_0_{t}.png"))
        want = cv2.imread(str(outs["jax"][0] / f"B4-Site_0_{t}.png"))
        assert got.shape == want.shape == (47, 61, 3)
        np.testing.assert_array_equal(got, want)
        assert (want == [0, 0, 255]).all(-1).any()      # red edges drawn
    with open(outs["port"][1], "rb") as a, open(outs["jax"][1], "rb") as b:
        assert a.read() == b.read()


def test_draw_contour_overlay_matches_jax():
    from dynamorph_tpu.pipeline.segmentation import \
        draw_contour_overlay as jax_draw
    from dynamorph_tpu_torch.pipeline.segmentation import \
        draw_contour_overlay

    r = np.random.RandomState(54)
    seg = (r.rand(40, 50) * 60).astype(np.uint8)
    for phase in (r.randint(0, 256, (40, 50)).astype(np.uint8),
                  r.randn(40, 50), r.rand(40, 50, 3) * 300):
        np.testing.assert_array_equal(draw_contour_overlay(phase, seg),
                                      jax_draw(phase, seg))


@pytest.mark.parametrize("size", [128, 2048])
def test_save_traj_bbox_matches_jax(size, tmp_path):
    """The trajectory GIF (uint16 frames resized to 512 x 512, red boxes at
    the per-axis scale) decodes equal to the JAX package's, frame by
    frame."""
    from PIL import Image

    from dynamorph_tpu.track.visualize import save_traj_bbox as jax_gif
    from dynamorph_tpu_torch.track.visualize import save_traj_bbox

    r = np.random.RandomState(55)
    n = 3 if size == 128 else 2
    stack = r.randint(0, 65536, (n, size, size, 2)).astype(np.uint16)
    traj = {t: 1 for t in range(n)}
    pos = {t: np.array([size * (0.2 + 0.3 * t), size * 0.6]) for t in
           range(n)}
    save_traj_bbox(traj, pos, stack, str(tmp_path / "port.gif"))
    jax_gif(traj, pos, stack, str(tmp_path / "jax.gif"))
    a, b = Image.open(tmp_path / "port.gif"), Image.open(tmp_path / "jax.gif")
    assert a.n_frames == b.n_frames == n and a.size == b.size == (512, 512)
    for i in range(n):
        a.seek(i)
        b.seek(i)
        np.testing.assert_array_equal(np.asarray(a.convert("RGB")),
                                      np.asarray(b.convert("RGB")))
