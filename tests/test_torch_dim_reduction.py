"""The port's dimensionality reduction (PCA, native UMAP, the
``run_dim_reduction`` stage) against the JAX package on the CPU.

Latents: seeded, 2 wells x 160 rows x 256 columns, a decaying spectrum of
24 factors plus noise (latent vectors are strongly correlated), a mean
offset; entries of std about 0.3, the scale of a VQ-VAE's codebook
vectors. (PCA's fp32 differences scale with the latents: the components
agree to 1e-5, so the projections to about 1e-5 of the latents' 1-norm.)

Limits, all from fp32 and chosen before the runs:
- PCA: equal ``k``; components within 1e-5 absolute after sign
  normalisation; mean within 1e-6; explained variance and its ratio within
  1e-5 relative; transforms within 1e-4.
- UMAP: ``find_ab_params`` within 1e-6; kNN index sets equal wherever the
  k-th and (k+1)-th squared distances are further apart than the rounding
  of the squared-distance formula (``4 eps32 (|x|² + |y|²)``, the terms it
  cancels), squared distances within that rounding and distances within
  1e-5 relative; ``smooth_knn`` and the fuzzy graph within
  1e-6 on the same kNN; the spectral init within 1e-4 on the same graph;
  one SGD epoch fed the JAX package's own negatives within 1e-5 (the
  epochs after it diverge chaotically, by 5e-5 after two). A whole fit is
  held by structure: cluster separation and neighbour preservation as
  ``tests/test_umap_native.py`` asks of the JAX fit, and two fits with one
  seed bit-equal.
"""
import functools
import os
import pickle
import subprocess
import sys
import warnings
from pathlib import Path

import cv2
import jax
import numpy as np
import pytest
import torch

from dynamorph_tpu.config.schema import PipelineConfig as JaxPC
from dynamorph_tpu.pipeline.dim_reduction import dim_reduction as jax_dim
from dynamorph_tpu.reduce import pca as jax_pca
from dynamorph_tpu.reduce import umap_native as J
from dynamorph_tpu_torch.cli import run_dim_reduction
from dynamorph_tpu_torch.io.pickles import load_pickle, save_pickle
from dynamorph_tpu_torch.reduce import pca as port_pca
from dynamorph_tpu_torch.reduce import umap_native as P
from dynamorph_tpu_torch.reduce import umap_wrap as W
from dynamorph_tpu_torch.reduce.scatter import PANEL

ROOT = Path(__file__).resolve().parents[1]
WELLS = ("B2", "C3")
N_WELL, D, RANK = 160, 256, 24
EPS32 = float(np.finfo(np.float32).eps)


def _latents(seed=0):
    r = np.random.RandomState(seed)
    basis = r.randn(RANK, D)
    out = {}
    for i, well in enumerate(WELLS):
        z = (r.randn(N_WELL, RANK) * 0.9 ** np.arange(RANK)) @ basis
        out[well] = (0.1 * z + 0.02 * r.randn(N_WELL, D) + 0.05 + 0.03 * i
                     ).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def latents():
    return _latents()


@pytest.fixture(scope="module")
def pooled(latents):
    return np.concatenate([latents[w] for w in WELLS])


def _assert_pca_close(ours, ref):
    assert ours.n_components_ == ref.n_components_ >= 2
    np.testing.assert_allclose(ours.components_, ref.components_, rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(ours.mean_, ref.mean_, rtol=0, atol=1e-6)
    for attr in ("explained_variance_", "explained_variance_ratio_"):
        np.testing.assert_allclose(getattr(ours, attr), getattr(ref, attr),
                                   rtol=1e-5, atol=0)


def test_fit_pca_device_matches_jax(pooled):
    """The same k (cumulative fp32 ratio searched on the host), components
    after sign normalisation, mean and variances."""
    ours = port_pca.fit_pca_device(pooled, device="cpu")
    ref = jax_pca.fit_pca_device(pooled)
    _assert_pca_close(ours, ref)
    csum = np.cumsum(ours.explained_variance_ratio_)
    assert csum[-1] > 0.5 and (len(csum) == 1 or csum[-2] <= 0.5)


def test_svd_driver_is_gesvd_on_the_card():
    """PyTorch's default CUDA SVD (Jacobi gesvdj) leaves fp32 components
    about 2e-3 from orthonormal on a plate's latents, and gesvda raises on
    a rank-deficient plate (chip_smoke.py phase 10 shows both beside the
    fit), so the fit asks for cuSOLVER's gesvd; on the CPU the ``driver``
    argument must stay None."""
    assert port_pca.svd_driver(torch.device("cuda")) == "gesvd"
    assert port_pca.svd_driver(torch.device("cpu")) is None


def test_pca_pickle_is_a_sklearn_pca(pooled, tmp_path):
    """fit_pca's pca_model.pkl, written without sklearn, unpickles under
    sklearn as sklearn.decomposition.PCA, with no warning, holding the
    JAX package's attributes (names and dtypes), values within the PCA
    limits, and transforms within 1e-4 of the JAX pickle's."""
    from sklearn.decomposition import PCA

    labels = np.repeat([0, 1], N_WELL)
    port_pca.fit_pca(pooled, str(tmp_path / "ours"), labels, list(WELLS),
                     device="cpu")
    # what the JAX package's fit_pca pickles, without its figure
    save_pickle(jax_pca._as_sklearn_pca(jax_pca.fit_pca_device(pooled),
                                        len(pooled)),
                str(tmp_path / "ref" / "pca_model.pkl"))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ours = load_pickle(str(tmp_path / "ours" / "pca_model.pkl"))
    ref = load_pickle(str(tmp_path / "ref" / "pca_model.pkl"))
    assert type(ours) is PCA and type(ref) is PCA
    assert list(ours.__getstate__()) == list(ref.__getstate__())
    for key, value in ref.__getstate__().items():
        if key == "_sklearn_version":       # sklearn's own, on both sides
            continue
        mine = getattr(ours, key)
        if isinstance(value, np.ndarray):
            assert mine.dtype == value.dtype and mine.shape == value.shape
        else:
            assert type(mine) is type(value) and (
                key.endswith("_") or mine == value), key
    _assert_pca_close(ours, ref)
    np.testing.assert_allclose(ours.singular_values_, ref.singular_values_,
                               rtol=1e-5)
    np.testing.assert_allclose(ours.transform(pooled),
                               ref.transform(pooled), rtol=0, atol=1e-4)
    png = cv2.imread(str(tmp_path / "ours" / "PCA.png"))
    assert png.ndim == 3 and (png != 255).any()


_NO_SKLEARN = r"""
import importlib.abc, sys
sys.modules["jax"] = None

class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("sklearn", "dynamorph_tpu"):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, _Block())
from dynamorph_tpu_torch.reduce.pca_model import process_pca
root = sys.argv[1]
for kind in ("sklearn", "port", "jax_model"):
    process_pca(root + "/in", root + "/out_" + kind, root + "/w_" + kind,
                "B2")
bad = [m for m in sys.modules if m.split(".")[0] in ("sklearn",
                                                     "dynamorph_tpu",
                                                     "torch")]
assert not bad, bad
print("ok")
"""


def test_process_pca_reads_three_pickles_without_sklearn(pooled, latents,
                                                          tmp_path):
    """In a process where sklearn and the JAX package cannot be imported,
    process_pca reads a real sklearn PCA, the port's pickle and the JAX
    package's PCAModel, and writes *_PCAed.pkl within 1e-4 of the JAX
    package's process_pca on the same model. The host transform needs no
    torch either (reduce/pca_model.py), so the process never imports
    it."""
    from sklearn.decomposition import PCA

    (tmp_path / "in").mkdir()
    save_pickle(latents["B2"], str(tmp_path / "in" /
                                   "B2_latent_space_after.pkl"))
    models = {"sklearn": PCA(0.5, whiten=True).fit(pooled),
              "jax_model": jax_pca.fit_pca_device(pooled)}
    for kind, model in models.items():
        save_pickle(model, str(tmp_path / f"w_{kind}" / "pca_model.pkl"))
    port_pca.fit_pca(pooled, str(tmp_path / "w_port"), np.zeros(len(pooled)),
                     ["all"], device="cpu")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "-c", _NO_SKLEARN, str(tmp_path)],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0 and res.stdout.split() == ["ok"], \
        res.stderr[-4000:]
    name = "B2_latent_space_after_PCAed.pkl"
    for kind in ("sklearn", "port", "jax_model"):
        jax_pca.process_pca(str(tmp_path / "in"), str(tmp_path / f"ref_{kind}"),
                            str(tmp_path / f"w_{kind}"), "B2")
        ours = load_pickle(str(tmp_path / f"out_{kind}" / name))
        ref = load_pickle(str(tmp_path / f"ref_{kind}" / name))
        assert ours.dtype == ref.dtype and ours.shape == ref.shape, kind
        np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4,
                                   err_msg=kind)


# ---------------------------------------------------------------- UMAP


def test_find_ab_params_matches_jax():
    for spread, min_dist in ((1.0, 0.1), (1.5, 0.3)):
        np.testing.assert_allclose(P.find_ab_params(spread, min_dist),
                                   J.find_ab_params(spread, min_dist),
                                   rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def knn(latents):
    """Unit-scale latents (the fixture's over their std) and both
    packages' kNN graphs, k = 15, blocks of 128 rows."""
    x = latents["B2"] / latents["B2"].std()
    return (x, J.knn_graph(x, 15, block=128),
            P.knn_graph(x, 15, block=128, device="cpu"))


def test_knn_graph_matches_jax(knn):
    x, (ij, dj), (ip, dp) = knn
    x64 = x.astype(np.float64)
    sq = (x64 * x64).sum(1)
    exact = ((x64[:, None] - x64[None]) ** 2).sum(-1)
    np.fill_diagonal(exact, np.inf)
    kth = np.sort(exact, 1)
    rounding = 4 * EPS32 * (sq[:, None] + sq[None]).max(1)
    clear = kth[:, 15] - kth[:, 14] > 2 * rounding
    assert clear.mean() > 0.9
    # neighbours within a row may swap places at near-equal distances
    np.testing.assert_array_equal(np.sort(ip[clear], 1),
                                  np.sort(ij[clear], 1))
    assert ip.dtype == ij.dtype and dp.dtype == dj.dtype == np.float64
    assert (np.abs(dp ** 2 - dj ** 2) <= rounding[:, None]).all()
    np.testing.assert_allclose(dp, dj, rtol=1e-5, atol=0)


def test_smooth_knn_and_fuzzy_graph_match_jax(knn, monkeypatch):
    """On the same kNN: rho and sigma, and the fuzzy graph."""
    x, (ij, dj), _ = knn
    rho, sigma = P.smooth_knn(dj)
    rho_j, sigma_j = J.smooth_knn(dj)
    np.testing.assert_allclose(rho, rho_j, rtol=0, atol=1e-6)
    np.testing.assert_allclose(sigma, sigma_j, rtol=0, atol=1e-6)
    monkeypatch.setattr(J, "knn_graph", lambda x, k: (ij, dj))
    ref = J.fuzzy_simplicial_set(x, 15)
    ours = P.fuzzy_from_knn(ij, dj)
    assert (ours != ref).nnz == 0 or abs(ours - ref).max() <= 1e-6
    assert ours.shape == ref.shape and ours.nnz == ref.nnz


def test_spectral_init_matches_jax(knn):
    x, (ij, dj), _ = knn
    graph = P.fuzzy_from_knn(ij, dj)
    ours, kind = P.spectral_init(graph, 2, 0)
    ref = J.spectral_init(graph, 2, 0)
    assert kind == "spectral" and ours.dtype == ref.dtype == np.float32
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4)


def test_spectral_init_clamps_ncv(monkeypatch):
    """At n = 5 the JAX package asks eigsh for a Lanczos basis of 7 > n
    vectors (umap_native.py:184); the port clamps it to n and gets the
    Laplacian's eigenvectors. (scipy 1.17 clamps it itself, so the JAX
    call does not fail with it, and both embeddings agree.)"""
    from scipy import sparse
    from scipy.sparse import linalg as slinalg

    asked = []
    eigsh = slinalg.eigsh

    def recording(*args, **kwargs):
        asked.append(kwargs["ncv"])
        return eigsh(*args, **kwargs)

    monkeypatch.setattr(slinalg, "eigsh", recording)
    r = np.random.RandomState(2)
    w = r.rand(5, 5)
    graph = sparse.csr_matrix(np.triu(w, 1) + np.triu(w, 1).T)
    ref = J.spectral_init(graph, 2, 0)
    emb, kind = P.spectral_init(graph, 2, 0)
    assert asked == [7, 5] and kind == "spectral"
    np.testing.assert_allclose(emb, ref, rtol=0, atol=1e-4)
    deg = np.asarray(graph.sum(1)).ravel()
    lap = np.eye(5) - graph.toarray() / np.sqrt(np.outer(deg, deg))
    vecs = np.linalg.eigh(lap)[1][:, 1:3]
    for i in range(2):
        col = emb[:, i] / np.linalg.norm(emb[:, i])
        assert abs(abs(col @ vecs[:, i]) - 1) < 1e-4


def _jax_negatives(seed, n_epochs, n_negs, n):
    """The negatives of the JAX package's _optimize (umap_native.py:
    246-248): split the key, randint over the subkey, each epoch."""
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(n_epochs):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.randint(sub, (n_negs,), 0, n)))
    return out


def test_one_epoch_matches_jax_with_its_negatives(knn):
    x, (ij, dj), _ = knn
    graph = P.fuzzy_from_knn(ij, dj)
    keep = graph.data >= graph.data.max() / 500.0
    coo = graph.tocoo()
    heads, tails, wts = coo.row[keep], coo.col[keep], coo.data[keep]
    emb0, _ = P.spectral_init(graph, 2, 0)
    ref = J._optimize(emb0, heads, tails, wts, 1.58, 0.9, 1, 5, 1.0, 7)
    negs = _jax_negatives(7, 1, 5 * len(heads), len(x))
    ours = P._optimize(emb0, heads, tails, wts, 1.58, 0.9, 1, 5, 1.0, 7,
                       device="cpu", negatives=negs)
    assert np.abs(ref - emb0).max() > 1.0           # the epoch moved it
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def one_thread():
    """The SGD's small ops run faster on one thread than on contended
    ones; restored after the module."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_native_umap_separates_clusters_reproducibly(one_thread):
    """tests/test_umap_native.py's clusters (three 10-D Gaussians of 150):
    nearest-centroid assignment in the embedding recovers > 99% of the
    labels, and a second fit with the seed is bit-equal (200 epochs, not
    the 500 of a fit this size, to save time)."""
    rng = np.random.RandomState(0)
    centers = rng.randn(3, 10) * 8
    x = np.concatenate([centers[i] + rng.randn(150, 10) for i in range(3)]
                       ).astype(np.float32)
    y = np.repeat([0, 1, 2], 150)
    model = P.NativeUMAP(a=1.58, b=0.9, n_neighbors=15, n_epochs=200,
                         device="cpu")
    emb = model.fit_transform(x)
    assert model.init_ == "spectral" and emb.shape == (450, 2)
    cents = np.stack([emb[y == i].mean(0) for i in range(3)])
    pred = np.argmin(((emb[:, None] - cents[None]) ** 2).sum(-1), 1)
    assert (pred == y).mean() > 0.99
    again = P.NativeUMAP(a=1.58, b=0.9, n_neighbors=15, n_epochs=200,
                         device="cpu").fit_transform(x)
    np.testing.assert_array_equal(emb, again)


def test_native_umap_preserves_neighbours(one_thread):
    """On a swiss roll of 400 points the embedding's trustworthiness
    beats 0.9 and does not lose to PCA's (the bar tests/test_umap_native.py
    sets the JAX fit; 200 epochs)."""
    from sklearn.datasets import make_swiss_roll
    from sklearn.decomposition import PCA
    from sklearn.manifold import trustworthiness

    x, _ = make_swiss_roll(n_samples=400, random_state=0)
    x = x.astype(np.float32)
    emb = P.NativeUMAP(n_neighbors=15, n_epochs=200,
                       device="cpu").fit_transform(x)
    t_umap = trustworthiness(x, emb, n_neighbors=10)
    t_pca = trustworthiness(x, PCA(2).fit_transform(x), n_neighbors=10)
    assert t_umap > 0.9 and t_umap >= t_pca - 0.01


# ---------------------------------------------------------------- stage


@pytest.fixture
def stage_dir(latents, tmp_path):
    """An input dir holding both wells' <well>_latent_space_after.pkl."""
    for well in WELLS:
        save_pickle(latents[well], str(tmp_path / "in" /
                                       f"{well}_latent_space_after.pkl"))
    return tmp_path


def _write_cfg(root, pkg, fit):
    path = root / f"{pkg}_{fit}.yml"
    path.write_text(
        "dim_reduction:\n"
        f"  input_dirs: ['{root / 'in'}']\n"
        f"  output_dirs: ['{root / ('out_' + pkg)}']\n"
        f"  weights_dir: '{root / ('w_' + pkg)}'\n"
        f"  file_name_prefixes: {list(WELLS)}\n  fit_model: {fit}\n")
    return str(path)


@pytest.fixture
def no_jax_render(monkeypatch):
    """The JAX package's figures are not compared: its savefig only
    touches the file, so the 300 dpi rendering costs no test time."""
    import matplotlib.figure

    monkeypatch.setattr(matplotlib.figure.Figure, "savefig",
                        lambda self, path, **kw: Path(path).touch())


def _run_jax(method, root, fit):
    cfg = JaxPC()
    cfg.dim_reduction.file_name_prefixes = list(WELLS)
    cfg.dim_reduction.fit_model = fit
    cfg.dim_reduction.conditions = None
    jax_dim(method, [str(root / "in")], [str(root / "out_ref")],
            str(root / "w_ref"), cfg)


def test_run_dim_reduction_pca_matches_jax(stage_dir, no_jax_render):
    """-m pca --device cpu, fit (fit_model: true) then transform: the
    pca_model.pkl of the pooled wells and each well's *_PCAed.pkl, against
    the JAX dim_reduction on the same latent files."""
    root = stage_dir
    for fit in (True, False):
        run_dim_reduction.main(["-m", "pca", "--device", "cpu", "-c",
                                _write_cfg(root, "ours", fit)])
        _run_jax("pca", root, fit)
    assert sorted(os.listdir(root / "w_ours")) == \
        sorted(os.listdir(root / "w_ref")) == ["PCA.png", "pca_model.pkl"]
    _assert_pca_close(load_pickle(str(root / "w_ours" / "pca_model.pkl")),
                      load_pickle(str(root / "w_ref" / "pca_model.pkl")))
    names = sorted(os.listdir(root / "out_ref"))
    assert sorted(os.listdir(root / "out_ours")) == names == [
        f"{w}_latent_space_after_PCAed.pkl" for w in WELLS]
    for f in names:
        ours = load_pickle(str(root / "out_ours" / f))
        ref = load_pickle(str(root / "out_ref" / f))
        assert ours.dtype == ref.dtype and ours.shape == ref.shape
        np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4)


def test_run_dim_reduction_umap_matches_jax(stage_dir, monkeypatch,
                                            one_thread, no_jax_render):
    """-m umap --device cpu with umap-learn absent: the native fit over the
    reference grid (n_neighbors 15, 50, 200; a 1.58, b 0.9) on the pooled
    320 latents writes the files the JAX dim_reduction writes, each
    [embedding, labels] with the same labels and a finite (320, 2)
    float32 embedding, and UMAP.png. Both packages' fits are cut to 5
    epochs here (the embeddings differ by their negatives anyway)."""
    root = stage_dir
    monkeypatch.setitem(sys.modules, "umap", None)
    monkeypatch.setattr(J, "NativeUMAP",
                        functools.partial(J.NativeUMAP, n_epochs=5))
    monkeypatch.setattr(W, "NativeUMAP",
                        functools.partial(P.NativeUMAP, n_epochs=5))
    run_dim_reduction.main(["-m", "umap", "--device", "cpu", "-c",
                            _write_cfg(root, "ours", True)])
    _run_jax("umap", root, True)
    names = sorted(os.listdir(root / "w_ref"))
    assert sorted(os.listdir(root / "w_ours")) == names == [
        "UMAP.png"] + [f"umap_nbr{k}_a1.58_b0.9.pkl" for k in (15, 200, 50)]
    for f in names[1:]:
        (emb, labels), (emb_j, labels_j) = (
            load_pickle(str(root / w / f)) for w in ("w_ours", "w_ref"))
        assert labels == labels_j and len(labels) == 2 * N_WELL
        assert emb.shape == emb_j.shape == (2 * N_WELL, 2)
        assert emb.dtype == emb_j.dtype == np.float32
        assert np.isfinite(emb).all()
    png = cv2.imread(str(root / "w_ours" / "UMAP.png"))
    assert png.shape == (PANEL[0], 3 * PANEL[1], 3) and (png != 255).any()


def test_fit_umap_is_native_where_umap_learn_imports(latents, monkeypatch,
                                                    tmp_path, one_thread):
    """fit_umap fits natively on the device it is given even where a
    ``umap`` module imports (the JAX package would take umap-learn's
    host fit there)."""
    class _Refused:
        def UMAP(self, **kwargs):
            raise AssertionError("umap-learn was used")

    monkeypatch.setitem(sys.modules, "umap", _Refused())
    monkeypatch.setattr(W, "NativeUMAP",
                        functools.partial(P.NativeUMAP, n_epochs=5))
    x = latents[WELLS[0]][:64]
    (reducer,) = W.fit_umap(x, str(tmp_path), [0] * len(x), ["B2"],
                            n_nbrs=(5,), device="cpu")
    assert isinstance(reducer, P.NativeUMAP)
    assert reducer.device == torch.device("cpu")
    emb, labels = load_pickle(str(tmp_path / "umap_nbr5_a1.58_b0.9.pkl"))
    assert emb.shape == (64, 2) and np.isfinite(emb).all()


class _Projector:
    """A fitted model with a transform: the first two latent columns."""

    def transform(self, x):
        return x[:, :2] * 2.0


def test_umap_transform_applies_models_and_skips_embeddings(stage_dir):
    """umap_transform applies each umap*.pkl that has a transform and skips
    the [embedding, labels] pickles fit_umap writes, as the JAX package's
    does."""
    from dynamorph_tpu.reduce.umap_wrap import (
        umap_transform as jax_umap_transform)
    from dynamorph_tpu_torch.reduce.umap_wrap import umap_transform

    root = stage_dir
    save_pickle(_Projector(), str(root / "w" / "umap_model.pkl"))
    save_pickle([np.zeros((3, 2)), [0, 0, 1]],
                str(root / "w" / "umap_nbr15_a1.58_b0.9.pkl"))
    umap_transform(str(root / "in"), str(root / "ours"), str(root / "w"),
                   "B2")
    jax_umap_transform(str(root / "in"), str(root / "ref"), str(root / "w"),
                       "B2")
    names = sorted(os.listdir(root / "ref"))
    assert sorted(os.listdir(root / "ours")) == names == [
        "B2_latent_space_after_umap_model.pkl"]
    np.testing.assert_array_equal(load_pickle(str(root / "ours" / names[0])),
                                  load_pickle(str(root / "ref" / names[0])))


def test_entry_points_raise_without_card(stage_dir, pooled):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    root = stage_dir
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_pca.fit_pca_device(pooled)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.NativeUMAP()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_dim_reduction.main(["-m", "pca", "-c",
                                _write_cfg(root, "ours", True)])
