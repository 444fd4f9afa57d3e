"""The port's latent encoding end to end (``process_vae``, VAE branch, and
``run_vae -m process``) against the JAX package on one synthetic well.

Latents: max-abs 1e-4 for z_before (f32 conv summation order, XLA-CPU vs
oneDNN); z_after equal where the codebook indices agree, which they do
here.
"""
import os

import numpy as np
import pytest
import torch

import jax

from dynamorph_tpu.config.schema import (LatentEncodingConfig as JaxLE,
                                         PipelineConfig as JaxPC)
from dynamorph_tpu.models import VQVAEz16 as JaxZ16
from dynamorph_tpu.pipeline.patch_vae import process_vae as jax_process_vae
from dynamorph_tpu_torch.cli import run_vae
from dynamorph_tpu_torch.io.pickles import load_pickle, save_pickle
from dynamorph_tpu_torch.models import VQVAEz16
from dynamorph_tpu_torch.models.jax_import import state_dict_from_jax
from dynamorph_tpu_torch.pipeline.patch_vae import (_save_recon_images,
                                                    encode_patches,
                                                    process_vae)
from test_torch_train import _few_threads  # noqa: F401

WELL = "C5"
SITES = ["C5-Site_0", "C5-Site_1"]
N = 5
LE = dict(network="VQ_VAE_z16", num_hiddens=16, num_residual_hiddens=32,
          num_embeddings=64, save_output=False)


def init_at_level_1(init, key):
    """``jax.jit(init)(key)`` compiled at XLA backend optimisation level 1:
    an init is threefry bits and their uniform or normal transforms, which
    come out bit-equal at level 1 for the z16 VQ-VAE (all 59 leaves), and
    the compile takes 2 s instead of 6-12."""
    compiled = jax.jit(init).lower(key).compile(
        compiler_options={"xla_backend_optimization_level": 1})
    return compiled(key)


@pytest.fixture(scope="module")
def well(tmp_path_factory):
    """raw dir with <well>_file_paths.pkl and a float64 (N, 2, 1, 128, 128)
    <well>_static_patches.pkl, and weights/model.pt of reference names
    written from a JAX-initialised model."""
    root = tmp_path_factory.mktemp("well")
    raw = root / "raw"
    raw.mkdir()
    r = np.random.RandomState(0)
    fs = [f"/supp/{WELL}-supps/{SITES[i % 2]}/{i}_{i + 1}.h5"
          for i in range(N)]
    data = r.rand(N, 2, 1, 128, 128) * 65535.0
    data[:, 1] *= 0.2
    save_pickle(fs, str(raw / f"{WELL}_file_paths.pkl"))
    save_pickle(data, str(raw / f"{WELL}_static_patches.pkl"))
    params, state = jax.device_get(
        init_at_level_1(JaxZ16(vq_impl="xla").init, jax.random.PRNGKey(1)))
    weights = root / "weights"
    weights.mkdir()
    torch.save(state_dict_from_jax(params, state, "VQ_VAE_z16"),
               str(weights / "model.pt"))
    return str(raw), str(root / "supp"), str(weights)


def _latents(raw, model_name="weights"):
    out = os.path.join(raw, model_name)
    return {f: load_pickle(os.path.join(out, f)) for f in sorted(os.listdir(out))}


def _port_config(weights):
    from dynamorph_tpu_torch.config.schema import (LatentEncodingConfig,
                                                   PipelineConfig)

    return PipelineConfig(latent_encoding=LatentEncodingConfig(
        weights=weights, **LE))


def test_process_vae_matches_jax(well, tmp_path):
    raw, supp, weights = well
    jraw = tmp_path / "jax_raw"
    jraw.mkdir()
    for f in os.listdir(raw):
        if f.endswith(".pkl"):
            os.symlink(os.path.join(raw, f), jraw / f)
    jax_process_vae(str(jraw), supp, SITES,
                    JaxPC(latent_encoding=JaxLE(weights=weights, **LE)),
                    batch_size=4)
    out = process_vae(raw, supp, SITES, _port_config(weights), batch_size=4,
                      device="cpu")
    assert out["output_dir"] == os.path.join(raw, "weights")
    ours, ref = _latents(raw), _latents(str(jraw))
    assert sorted(ours) == sorted(ref) == [
        f"{WELL}_latent_space.pkl", f"{WELL}_latent_space_after.pkl"]
    for f in ours:
        assert ours[f].shape == ref[f].shape == (N, 16 * 16 * 16)
        assert ours[f].dtype == ref[f].dtype == np.float32
    zb, zb_j = ours[f"{WELL}_latent_space.pkl"], ref[f"{WELL}_latent_space.pkl"]
    assert np.max(np.abs(zb - zb_j)) <= 1e-4
    np.testing.assert_array_equal(ours[f"{WELL}_latent_space_after.pkl"],
                                  ref[f"{WELL}_latent_space_after.pkl"])


def test_cli_process_matches_library(well, tmp_path):
    """run_vae -m process --device cpu over the YAML config writes what
    process_vae writes."""
    raw, supp, weights = well
    process_vae(raw, supp, SITES, _port_config(weights), device="cpu")
    direct = _latents(raw)
    cfg = tmp_path / "cfg.yml"
    cfg.write_text(
        "latent_encoding:\n"
        f"  raw_dirs: ['{raw}']\n  supp_dirs: ['{supp}']\n"
        f"  weights: ['{weights}']\n  fov: {SITES}\n"
        "  save_output: False\n  network: 'VQ_VAE_z16'\n"
        "  num_hiddens: 16\n  num_residual_hiddens: 32\n"
        "  num_embeddings: 64\n")
    for f in direct:
        os.remove(os.path.join(raw, "weights", f))
    run_vae.main(["-m", "process", "-c", str(cfg), "--device", "cpu"])
    via_cli = _latents(raw)
    assert sorted(via_cli) == sorted(direct)
    for f in direct:
        np.testing.assert_array_equal(via_cli[f], direct[f])


def test_cli_assemble_then_process(well, tmp_path):
    """run_vae -m assemble --device cpu builds a well from per-site
    stacks_<t>.pkl and cell_traj.pkl (the unmasked "mat" patches, resized
    256 -> 128), and run_vae -m process encodes what it wrote."""
    _, _, weights = well
    raw, supp = tmp_path / "raw", tmp_path / "supp"
    raw.mkdir()
    r = np.random.RandomState(2)
    for site in SITES:
        folder = supp / f"{WELL}-supps" / site
        folder.mkdir(parents=True)
        np.save(raw / f"{site}.npy", np.zeros((2, 2, 1, 4, 4)))
        for t in range(2):
            save_pickle({str(folder / f"{t}_{cid}.h5"): {
                "mat": r.randint(0, 65535, (4, 1, 256, 256)) * 1.0,
                "masked_mat": np.zeros((4, 1, 256, 256))}
                for cid in (3, 7)}, str(folder / f"stacks_{t}.pkl"))
        save_pickle([[{0: 3, 1: 7}], [{0: np.array([5, 5]),
                                       1: np.array([6, 6])}]],
                    str(folder / "cell_traj.pkl"))
    cfg = tmp_path / "cfg.yml"
    cfg.write_text(
        "latent_encoding:\n"
        f"  raw_dirs: ['{raw}']\n  supp_dirs: ['{supp}']\n"
        f"  weights: ['{weights}']\n  save_output: False\n"
        "  network: 'VQ_VAE_z16'\n  num_hiddens: 16\n"
        "  num_residual_hiddens: 32\n  num_embeddings: 64\n")
    run_vae.main(["-m", "assemble", "-c", str(cfg), "--device", "cpu"])
    fs = load_pickle(str(raw / f"{WELL}_file_paths.pkl"))
    data = load_pickle(str(raw / f"{WELL}_static_patches.pkl"))
    assert fs == sorted(fs) and len(fs) == 8
    assert data.shape == (8, 2, 1, 128, 128) and data.dtype == np.float64
    assert data.any()                  # "mat", not the zero "masked_mat"
    labels = load_pickle(str(raw / f"{WELL}_static_patches_labels.pkl"))
    relations = load_pickle(
        str(raw / f"{WELL}_static_patches_relations.pkl"))
    i, j = fs.index(str(supp / f"{WELL}-supps" / SITES[0] / "0_3.h5")), \
        fs.index(str(supp / f"{WELL}-supps" / SITES[0] / "1_7.h5"))
    assert labels[i] == labels[j] and relations[(i, j)] == 2
    run_vae.main(["-m", "process", "-c", str(cfg), "--device", "cpu"])
    z = load_pickle(str(raw / "weights" / f"{WELL}_latent_space.pkl"))
    assert z.shape == (8, 16 * 16 * 16) and np.isfinite(z).all()


def test_entry_points_refuse_cpu_unless_asked(well, tmp_path):
    """Without a card and without device='cpu', every entry point raises:
    nothing drops to the CPU quietly."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    raw, supp, weights = well
    model = VQVAEz16()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        encode_patches(model, np.zeros((2, 2, 128, 128), np.float32))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        process_vae(raw, supp, SITES, _port_config(weights))
    cfg = tmp_path / "cfg.yml"
    cfg.write_text(
        "latent_encoding:\n"
        f"  raw_dirs: ['{raw}']\n  supp_dirs: ['{supp}']\n"
        f"  weights: ['{weights}']\n  fov: {SITES}\n  save_output: False\n")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_vae.main(["-m", "process", "-c", str(cfg)])


def test_encode_patches_pads_trailing_batch(well):
    """Batch size does not change the latents (the trailing batch is
    zero-padded and cut back)."""
    raw, _, weights = well
    model = VQVAEz16()
    model.load_state_dict(torch.load(os.path.join(weights, "model.pt")))
    data = load_pickle(os.path.join(raw, f"{WELL}_static_patches.pkl"))[:, :, 0]
    a = encode_patches(model, data, batch_size=2, normalize="patch",
                       device="cpu")
    b = encode_patches(model, data, batch_size=8, normalize="patch",
                       device="cpu")
    for x, y in zip(a, b):
        assert x.shape == (N, 4096)
        np.testing.assert_allclose(x, y, atol=1e-5)


def test_save_recon_images(well, tmp_path):
    raw, _, weights = well
    model = VQVAEz16()
    model.load_state_dict(torch.load(os.path.join(weights, "model.pt")))
    data = load_pickle(os.path.join(raw, f"{WELL}_static_patches.pkl"))[:, :, 0]
    _save_recon_images(model, data, str(tmp_path), n=2, device="cpu")
    inds = set(np.random.RandomState(0).randint(0, N, (2,)).tolist())
    assert sorted(os.listdir(tmp_path)) == sorted(
        f"recon_{i}.jpg" for i in inds)


class _RecordingWell:
    """A stand-in dataset of ``n`` patches that records which patches are
    read and hands out a tiny blank one."""

    def __init__(self, n):
        self.n, self.read = n, []

    def __len__(self):
        return self.n

    def __getitem__(self, sl):
        self.read.append(sl.start)
        return np.zeros((1, 2, 4, 4), np.float32)


def test_recon_draw_matches_jax_on_a_full_well(monkeypatch, tmp_path):
    """On a 2,304-patch well both packages' ``_save_recon_images`` read the
    same 20 patches (no figure is rendered: matplotlib's Figure and canvas
    are stubbed, the models are identities)."""
    from unittest import mock

    import matplotlib.backends.backend_agg
    import matplotlib.figure

    import dynamorph_tpu.train.data
    from dynamorph_tpu.pipeline.patch_vae import (
        _save_recon_images as jax_save_recon_images)
    from dynamorph_tpu_torch.pipeline import patch_vae as port_patch_vae

    monkeypatch.setattr(matplotlib.figure, "Figure", mock.MagicMock())
    monkeypatch.setattr(matplotlib.backends.backend_agg, "FigureCanvasAgg",
                        mock.MagicMock())
    monkeypatch.setattr(dynamorph_tpu.train.data, "zscore_patch",
                        lambda x: x)
    monkeypatch.setattr(port_patch_vae, "zscore_patch", lambda x: x)

    jax_well, port_well = _RecordingWell(2304), _RecordingWell(2304)
    jax_model = mock.Mock(apply=lambda p, s, x: (x, None, None))
    jax_save_recon_images(jax_model, {}, {}, jax_well, str(tmp_path))
    port_model = mock.Mock(apply=lambda x: (x, None))
    port_patch_vae._save_recon_images(port_model, port_well, str(tmp_path),
                                      device="cpu")
    assert len(jax_well.read) == 20
    assert port_well.read == jax_well.read
    assert port_patch_vae.recon_sample_indices(2304).tolist() == \
        jax_well.read


def test_run_pipeline_process_and_pca(well, tmp_path, monkeypatch):
    """run_pipeline --stages process pca --device cpu writes the latents
    that run_vae -m process writes, bit for bit, and a pca_model.pkl (the
    pca stage fits, fit_model: true) within the PCA limits of
    tests/test_torch_dim_reduction.py (k equal, components 1e-5, mean
    1e-6, variances 1e-5 relative, transforms 1e-4) of the JAX package's
    dim_reduction("pca") on the same latent files. The codebook is drawn
    from the encoder's own latent rows (a random one puts every position
    on one code, and z_after would be constant). The JAX package runs on
    8 virtual CPU devices here, where its fit takes the sharded covariance
    path; it is pointed at its one-device SVD path, the path of one
    card."""
    import matplotlib.figure

    from dynamorph_tpu.config.schema import DimReductionConfig
    from dynamorph_tpu.pipeline.dim_reduction import dim_reduction
    from dynamorph_tpu.reduce import pca as jax_pca
    from dynamorph_tpu_torch.cli import run_pipeline

    raw, supp, fixture_weights = well
    state = torch.load(os.path.join(fixture_weights, "model.pt"))
    model = VQVAEz16()
    model.load_state_dict(state)
    data = load_pickle(os.path.join(raw, f"{WELL}_static_patches.pkl"))
    z_b, _ = encode_patches(model, data[:, :, 0], normalize="patch",
                            device="cpu")
    rows = z_b.reshape(N, 16, -1).transpose(0, 2, 1).reshape(-1, 16)
    pick = np.random.RandomState(3).choice(len(rows), 64, replace=False)
    state["vq.w.weight"] = torch.from_numpy(rows[pick].copy())
    weights = tmp_path / "weights"
    weights.mkdir()
    torch.save(state, str(weights / "model.pt"))
    runs = {}
    for name in ("vae", "pipeline"):
        d = tmp_path / name
        d.mkdir()
        for f in os.listdir(raw):
            if f.endswith(".pkl"):
                os.symlink(os.path.join(raw, f), d / f)
        cfg = tmp_path / f"{name}.yml"
        cfg.write_text(
            f"patch:\n  raw_dirs: ['{d}']\n  supp_dirs: ['{supp}']\n"
            f"  fov: {SITES}\n"
            "latent_encoding:\n"
            f"  raw_dirs: ['{d}']\n  supp_dirs: ['{supp}']\n"
            f"  weights: ['{weights}']\n  fov: {SITES}\n"
            "  save_output: False\n  network: 'VQ_VAE_z16'\n"
            "  num_hiddens: 16\n  num_residual_hiddens: 32\n"
            "  num_embeddings: 64\n"
            "dim_reduction:\n"
            f"  input_dirs: ['{d / 'weights'}']\n"
            f"  weights_dir: '{tmp_path / 'pca_ours'}'\n"
            f"  file_name_prefixes: ['{WELL}']\n  fit_model: True\n")
        runs[name] = (str(d), str(cfg))
    run_vae.main(["-m", "process", "-c", runs["vae"][1], "--device", "cpu"])
    executed = run_pipeline.main(["-c", runs["pipeline"][1], "--stages",
                                  "process", "pca", "--device", "cpu"])
    assert executed == {runs["pipeline"][0]: ["process", "pca"]}
    ours, ref = _latents(runs["pipeline"][0]), _latents(runs["vae"][0])
    assert sorted(ours) == sorted(ref) and len(ours) == 2
    for f in ours:
        np.testing.assert_array_equal(ours[f], ref[f])

    # the JAX package's stage on the same latent files (its figure is not
    # compared: savefig only touches the file)
    monkeypatch.setattr(matplotlib.figure.Figure, "savefig",
                        lambda self, path, **kw: open(path, "wb").close())
    monkeypatch.setattr(jax_pca, "fit_pca_distributed",
                        lambda x, fraction: jax_pca.fit_pca_device(x, fraction))
    jcfg = JaxPC(dim_reduction=DimReductionConfig(
        file_name_prefixes=[WELL], fit_model=True, conditions=None))
    latent_dir = os.path.join(runs["pipeline"][0], "weights")
    dim_reduction("pca", [latent_dir], [latent_dir],
                  str(tmp_path / "pca_ref"), jcfg)
    assert sorted(os.listdir(tmp_path / "pca_ours")) == \
        sorted(os.listdir(tmp_path / "pca_ref")) == ["PCA.png",
                                                     "pca_model.pkl"]
    m, m_ref = (load_pickle(str(tmp_path / d / "pca_model.pkl"))
                for d in ("pca_ours", "pca_ref"))
    assert m.n_components_ == m_ref.n_components_
    np.testing.assert_allclose(m.components_, m_ref.components_, rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(m.mean_, m_ref.mean_, rtol=0, atol=1e-6)
    for attr in ("explained_variance_", "explained_variance_ratio_"):
        np.testing.assert_allclose(getattr(m, attr), getattr(m_ref, attr),
                                   rtol=1e-5)
    z = ours[f"{WELL}_latent_space_after.pkl"]
    np.testing.assert_allclose(m.transform(z), m_ref.transform(z), rtol=0,
                               atol=1e-4)
