"""The port's VAE, IWAE and AAE (models, train step, trainer, ``run_vae -m
process`` and ``run_training``) against the JAX package.

Weights are drawn with numpy on the JAX package's tree (``jax.eval_shape``
of ``init``, so no init program is compiled), batch norm moved off the
identity, and carried over with ``state_dict_from_jax``. The inputs are
z-scored 128 x 128 patches (the AAE's discriminator needs 16 x 16
latents). The JAX side runs one jitted program per network. Noise is the
JAX package's own draw, fed to the port (``eps``, ``fixed_eps``,
``z_prior``). Tolerances, with their reasons:

- latents, decodes and the log-likelihood bound: max-abs 1e-4 of the
  largest value (fp32 convolution summation order, XLA-CPU vs oneDNN, as
  tests/test_torch_pipeline_vae.py);
- one train-mode step's losses rtol 1e-5; batch-norm buffers atol 1e-6.
- its gradients are held against the same step in float64 (the port on
  the CPU), as chip_smoke.py holds the card against the CPU: per tensor,
  the port's max-abs error is at most 3 x the JAX package's plus 1e-6 of
  the model's largest gradient. Held directly against JAX at
  tests/test_torch_train.py's rule (rtol 1e-3, atol 1e-5 of the tensor's
  largest gradient), two small gradients that sum large cancelling terms
  miss by rounding alone: the stem's 1x1 bias, which reaches the loss only
  through the fused stem's zero-padded border, and the last residual batch
  norm's offset of the AAE, whose recon loss is a mean (measured: both
  packages 0.9-1.7e-5 from float64 on a 0.35 maximum). Biases of
  convolutions that feed a batch norm have an exact gradient of 0: both
  sides stay below 1e-5 of the model's largest gradient.
"""
import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dynamorph_tpu.config.schema import (LatentEncodingConfig as JaxLE,
                                         PipelineConfig as JaxPC)
from dynamorph_tpu.models import vae as jvae
from dynamorph_tpu.models.torch_import import import_aae, import_vae
from dynamorph_tpu.pipeline import patch_vae as jax_patch_vae
from dynamorph_tpu.train.data import zscore_patch
from dynamorph_tpu_torch.cli import run_training, run_vae
from dynamorph_tpu_torch.io.pickles import load_pickle, save_pickle
from dynamorph_tpu_torch.models import AAEModel, IWAEModel, VAEModel
from dynamorph_tpu_torch.models.jax_import import (load_reference_checkpoint,
                                                   state_dict_from_jax)
from dynamorph_tpu_torch.models.registry import build_model
from dynamorph_tpu_torch.pipeline.patch_vae import _load_model_weights
from dynamorph_tpu_torch.train.steps import make_eval_step, make_train_step
from test_torch_train import _few_threads, _pre_bn_biases  # noqa: F401

NETS = {"VAE": (jvae.VAEModel, VAEModel), "IWAE": (jvae.IWAEModel, IWAEModel),
        "AAE": (jvae.AAEModel, AAEModel)}
# small widths; the loss weights of configs/config_example.yml:75-113
KW = dict(num_hiddens=8, num_residual_hiddens=8, weight_matching=100.0,
          margin=1.0, w_a=1.0, w_t=0.5, w_n=-0.5)
K = 3                                   # IWAE samples
B = 3
WELL, SITES = "C5", ["C5-Site_0", "C5-Site_1"]
ATOL = 1e-4                             # of the largest value
# gradients against a float64 step: the port's fp32 error, per tensor, at
# most 3 x the JAX package's plus 1e-6 of the model's largest gradient
GRAD_VS_JAX = 3.0
GRAD_FLOOR = 1e-6


def numpy_weights(model, seed):
    """The JAX model's (params, state) drawn with numpy: kernels at
    1/sqrt(fan in), batch norm off the identity."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    r = np.random.RandomState(seed)

    def draw(path, leaf):
        name = str(getattr(path[-1], "key", ""))
        shape = leaf.shape
        if name in ("kernel", "weight", "codebook"):
            fan_in = int(np.prod(shape[:-1])) if name != "codebook" else 1
            v = r.randn(*shape) / np.sqrt(max(fan_in, 1))
        elif name == "scale":
            v = 1 + 0.2 * r.randn(*shape)
        elif name == "var":
            v = r.uniform(0.5, 1.5, shape)
        else:                           # bias, offset, running mean
            v = 0.1 * r.randn(*shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _well_patches(seed=0, n=B, size=128):
    r = np.random.RandomState(seed)
    raw = r.rand(n, 2, 1, size, size) * 65535.0
    raw[:, 1] *= 0.2
    return raw


def _jax_side(name, jmodel, params, state, x, rel, mask, key):
    """Everything the tests hold the port against, in one jitted program:
    encode, predict, a train-mode loss and its gradient, the IWAE bound
    and the AAE's eval-mode adversarial losses."""

    def run(params, state, x, rel, mask, key):
        out = {"encode": jmodel.encode(params, state, x)[0]}
        if name != "AAE":
            out["predict"], out["predict_losses"] = jmodel.predict(
                params, state, x)

        def loss_fn(p):
            kw = dict(train=True, time_matching_mat=rel, batch_mask=mask)
            if name == "AAE":
                _, losses, ns = jmodel.apply(p, state, x, **kw)
            else:
                _, losses, ns = jmodel.apply(p, state, x, key, **kw)
            return losses["total_loss"], (losses, ns)

        (_, (out["losses"], out["new_state"])), out["grads"] = \
            jax.value_and_grad(loss_fn, has_aux=True)(params)
        if name == "IWAE":
            out["bound"] = jmodel.log_likelihood_bound(params, state, x, key)
        if name == "AAE":
            out["adv"], _ = jmodel.adversarial_loss(params, state, x, key,
                                                    train=False)
        return out

    return jax.device_get(jax.jit(run)(params, state, jnp.asarray(x),
                                       jnp.asarray(rel, jnp.float32),
                                       jnp.asarray(mask), key))


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(
        np.asarray(a), -1, -3)))


@pytest.fixture(scope="module", params=sorted(NETS))
def pair(request):
    name = request.param
    jcls, tcls = NETS[name]
    extra = dict(k=K) if name == "IWAE" else {}
    jmodel = jcls(**KW, **extra)
    params, state = numpy_weights(jmodel, seed=len(name))
    raw = _well_patches()
    x = zscore_patch(raw[:, :, 0]).astype(np.float32)
    r = np.random.RandomState(7)
    mask = (r.rand(B, 2, 128, 128) > 0.3).astype(np.float32)
    rel = r.randint(0, 3, (B, B)).astype(np.uint8)
    key = jax.random.PRNGKey(11)
    jx = _jax_side(name, jmodel, params, state, x, rel, mask, key)
    model = tcls(**KW, **extra)
    sd = state_dict_from_jax(params, state, name)
    model.load_state_dict(sd, strict=True)
    # the train step below moves the running statistics
    eval_model = copy.deepcopy(model)
    model64 = copy.deepcopy(model).double()
    # JAX's own noise, as the JAX functions draw it from ``key``
    zshape = (B, 16, 16, KW["num_hiddens"])
    noise = {}
    if name == "VAE":
        noise["eps"] = _nchw(jax.random.normal(key, zshape))
    if name == "IWAE":
        keys = jax.random.split(key, K)
        noise["fixed_eps"] = _nchw(jax.vmap(
            lambda k: jax.random.normal(k, zshape))(keys))
    if name == "AAE":
        noise["z_prior"] = _nchw(jax.random.normal(
            jax.random.split(key, 3)[0], zshape))
    step_noise = {k: v for k, v in noise.items() if k != "z_prior"}
    _, losses = model.apply(
        torch.from_numpy(x), train=True, time_matching_mat=rel,
        batch_mask=torch.from_numpy(mask), **step_noise)
    losses["total_loss"].backward()
    _, losses64 = model64.apply(
        torch.from_numpy(x).double(), train=True, time_matching_mat=rel,
        batch_mask=torch.from_numpy(mask).double(),
        **{k: v.double() for k, v in step_noise.items()})
    losses64["total_loss"].backward()
    grads64 = {n: p.grad for n, p in model64.named_parameters()}
    return dict(grads64=grads64, name=name, jmodel=jmodel, params=params,
                state=state, x=x, raw=raw, rel=rel, mask=mask, jx=jx,
                model=model, sd=sd, noise=noise, losses=losses,
                eval_model=eval_model)


def _close(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, what
    np.testing.assert_allclose(a, b, rtol=0, atol=ATOL * np.abs(b).max(),
                               err_msg=what)


def test_encode_matches_jax(pair):
    z_b, z_a, idx = pair["eval_model"].encode(torch.from_numpy(pair["x"]))
    assert idx is None and z_b is z_a
    assert z_b.shape == (B, KW["num_hiddens"], 16, 16)
    _close(z_b.numpy(), pair["jx"]["encode"], "encode")


def test_network_outputs_match_jax(pair):
    """VAE and IWAE: ``predict`` (the mean latent decoded); IWAE: the
    log-likelihood bound on JAX's draw, and repeatable from a generator;
    AAE (which has no ``predict`` in either package): the eval-mode
    adversarial losses on JAX's prior draw."""
    model, jx, name = pair["eval_model"], pair["jx"], pair["name"]
    x = torch.from_numpy(pair["x"])
    assert hasattr(model, "predict") == hasattr(pair["jmodel"], "predict")
    if name != "AAE":
        decoded, losses = model.predict(x)
        _close(decoded.numpy(), jx["predict"], "predict")
        np.testing.assert_allclose(float(losses["recon_loss"]),
                                   float(jx["predict_losses"]["recon_loss"]),
                                   rtol=1e-5)
    if name == "IWAE":
        bound = model.log_likelihood_bound(x, eps=pair["noise"]["fixed_eps"])
        want = float(jx["bound"])
        assert abs(float(bound) - want) <= 1e-5 * abs(want)
        g = [torch.Generator().manual_seed(3) for _ in range(2)]
        a, b = (model.log_likelihood_bound(x, generator=gi) for gi in g)
        assert float(a) == float(b) and np.isfinite(float(a))
    if name == "AAE":
        adv = model.adversarial_loss(x, train=False,
                                     z_prior=pair["noise"]["z_prior"])
        assert set(adv) == set(jx["adv"])
        for k, v in jx["adv"].items():
            np.testing.assert_allclose(float(adv[k]), float(v), rtol=1e-5,
                                       err_msg=k)


def test_train_losses_match_jax_with_its_noise(pair):
    losses, losses_j = pair["losses"], pair["jx"]["losses"]
    assert set(losses) == set(losses_j)
    for k in losses:
        np.testing.assert_allclose(float(losses[k].detach()),
                                   float(losses_j[k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    assert float(losses["time_matching_loss"].detach()) > 0


def test_train_gradients_match_jax(pair):
    model = pair["model"]
    grads_j = state_dict_from_jax(pair["jx"]["grads"], pair["state"],
                                  pair["name"])
    named = dict(model.named_parameters())
    assert set(named) == {k for k in grads_j if "running" not in k and
                          "num_batches" not in k and k != "channel_var"}
    scale = max(float(np.abs(g.numpy()).max()) for g in grads_j.values())
    zero = _pre_bn_biases(model)
    assert zero
    for name, p in named.items():
        g_j = grads_j[name].numpy().astype(np.float64)
        if name.startswith("enc_d."):
            # the AAE's discriminator is not on apply's path
            assert p.grad is None and not g_j.any(), name
            continue
        g = p.grad.numpy().astype(np.float64)
        if name in zero:
            assert np.abs(g).max() <= 1e-5 * scale, name
            assert np.abs(g_j).max() <= 1e-5 * scale, name
            continue
        g64 = pair["grads64"][name].numpy()
        err, err_j = np.abs(g - g64).max(), np.abs(g_j - g64).max()
        assert err <= GRAD_VS_JAX * err_j + GRAD_FLOOR * scale, \
            (name, err, err_j)
        # and the two fp32 steps agree to fp32 rounding of this tensor
        assert np.abs(g - g_j).max() <= 1e-3 * np.abs(g64).max() + \
            GRAD_FLOOR * scale, name


def test_train_bn_buffers_match_jax_new_state(pair):
    want = state_dict_from_jax(pair["params"], pair["jx"]["new_state"],
                               pair["name"])
    for name, buf in pair["model"].named_buffers():
        if "running" in name and not name.startswith("enc_d."):
            np.testing.assert_allclose(buf.numpy(), want[name].numpy(),
                                       rtol=0, atol=1e-6, err_msg=name)


def test_aae_dropout_draws_from_the_generator():
    """Train mode: the discriminator's two dropouts keep a unit where a
    uniform draw from the generator is below 0.75 and scale it by 4/3, in
    that order; the same seed gives the same losses, and torch's global
    generator is not used."""
    torch.manual_seed(0)
    model = AAEModel(**KW)
    x = torch.from_numpy(zscore_patch(_well_patches(1, 2)[:, :, 0])
                         .astype(np.float32))
    before = torch.random.get_rng_state()
    runs = [model.adversarial_loss(
        x, generator=torch.Generator().manual_seed(5)) for _ in range(2)]
    assert torch.equal(before, torch.random.get_rng_state())
    for k in runs[0]:
        assert float(runs[0][k].detach()) == float(runs[1][k].detach()), k
    z = torch.randn(512, KW["num_hiddens"], 16, 16)
    with torch.no_grad():
        got = model.discriminate(z, True, torch.Generator().manual_seed(6))
        g = torch.Generator().manual_seed(6)
        d = model.enc_d
        h = d[11](d[:11](z))
        keep = torch.rand(h.shape, generator=g) < 0.75
        assert abs(float(keep.float().mean()) - 0.75) < 0.01
        h = torch.relu(torch.where(keep, h / 0.75, 0.0))
        h = d[14](h)
        h = torch.relu(torch.where(torch.rand(h.shape, generator=g) < 0.75,
                                   h / 0.75, 0.0))
        want = torch.sigmoid(d[17](h))
    assert torch.equal(got, want)


def test_state_dict_names_are_the_references(pair):
    """The names ``dynamorph_tpu/models/torch_import.py`` reads: the
    z16 trunk, the VAE family's ``enc.13``, the AAE's ``enc_d``; a
    reference-format model.pt loads back strict."""
    sd = pair["model"].state_dict()
    assert set(sd) == set(pair["sd"])
    assert ("enc.13.weight" in sd) == (pair["name"] != "AAE")
    assert ("enc_d.17.weight" in sd) == (pair["name"] == "AAE")
    ref = {k: v.numpy() for k, v in sd.items()}

    params, state = (import_aae if pair["name"] == "AAE" else import_vae)(ref)
    back = state_dict_from_jax(jax.device_get(params), jax.device_get(state),
                               pair["name"])
    for k, v in back.items():
        if "num_batches" not in k:
            assert torch.equal(v, sd[k]), k


def test_registry_builds_from_one_config_section():
    """``build_model`` drops the keywords a network does not take (the
    VQ-only ones for the VAE family): the JAX package's process passes
    them to every class."""
    for name, (_, tcls) in NETS.items():
        model = build_model(name, num_inputs=2, num_hiddens=8,
                            num_residual_hiddens=8, num_residual_layers=2,
                            num_embeddings=16, commitment_cost=0.25,
                            vq_train_precision="high", weight_matching=5.0)
        assert type(model) is tcls and model.weight_matching == 5.0


# ------------------------------------------------------ train steps

def test_train_step_draws_noise_from_its_generator():
    """make_train_step and make_eval_step hand a VAE their generator (after
    the augmentation's draws); the same seed gives the same losses, another
    seed others, and torch's global generator is untouched."""
    x = torch.from_numpy(zscore_patch(_well_patches(2, 2, 32)[:, :, 0])
                         .astype(np.float32))
    torch.manual_seed(1)
    models = [IWAEModel(k=2, **KW) for _ in range(3)]
    init = copy.deepcopy(models[0].state_dict())
    out = []
    before = torch.random.get_rng_state()
    for seed, model in zip((4, 4, 5), models):
        model.load_state_dict(init)
        g = torch.Generator().manual_seed(seed)
        step = make_train_step(model, torch.optim.Adam(model.parameters()),
                               augment=True, generator=g)
        ev = make_eval_step(model, generator=g)
        out.append((float(step(x)["total_loss"]),
                    float(ev(x)["total_loss"])))
    assert torch.equal(before, torch.random.get_rng_state())
    assert out[0] == out[1] and out[0] != out[2]


# ------------------------------------------------------ process and CLIs

def _write_well(root, raw_patches):
    raw = root / "raw"
    raw.mkdir(parents=True)
    fs = [f"/supp/{WELL}-supps/{SITES[i % 2]}/{i}_{i + 1}.h5"
          for i in range(len(raw_patches))]
    save_pickle(fs, str(raw / f"{WELL}_file_paths.pkl"))
    save_pickle(raw_patches, str(raw / f"{WELL}_static_patches.pkl"))
    return raw


def _le(name, weights):
    return dict(network=name, weights=[str(weights)], save_output=False,
                num_hiddens=KW["num_hiddens"],
                num_residual_hiddens=KW["num_residual_hiddens"],
                num_embeddings=16, fov=SITES)


def _process_config(root, name, weights, raw):
    cfg = root / "cfg.yml"
    le = _le(name, weights)
    cfg.write_text(
        "latent_encoding:\n"
        f"  raw_dirs: ['{raw}']\n  supp_dirs: ['{root / 'supp'}']\n"
        + "".join(f"  {k}: {v!r}\n" for k, v in le.items()))
    return cfg


def test_process_matches_jax_encode(pair, tmp_path):
    """``run_vae -m process --device cpu`` on the fixture's well against
    the JAX package's ``encode`` of the same z-scored patches (its own
    ``process`` cannot build these networks: next test); the VAE family
    writes its latent as both pickles."""
    weights = tmp_path / "weights"
    weights.mkdir()
    torch.save(pair["sd"], str(weights / "model.pt"))
    raw = _write_well(tmp_path, pair["raw"])
    cfg = _process_config(tmp_path, pair["name"], weights, raw)
    run_vae.main(["-m", "process", "-c", str(cfg), "--device", "cpu"])
    out = raw / "weights"
    z_b = load_pickle(str(out / f"{WELL}_latent_space.pkl"))
    z_a = load_pickle(str(out / f"{WELL}_latent_space_after.pkl"))
    want = pair["jx"]["encode"].reshape(B, -1)
    assert z_b.dtype == np.float32 and np.array_equal(z_b, z_a)
    _close(z_b, want, "process")


@pytest.mark.parametrize("name,error,match", [
    ("VAE", TypeError, "num_embeddings"),
    ("IWAE", ValueError, "not available"),
    ("AAE", ValueError, "not available")])
def test_jax_process_cannot_build_the_vae_family(name, error, match,
                                                 tmp_path):
    """Fault 1 of the JAX package, which the port does not copy: its
    ``process`` passes ``num_embeddings`` and ``commitment_cost`` to every
    class (dynamorph_tpu/pipeline/patch_vae.py:194-203), which VAE does
    not take; IWAE and AAE do not even reach it, since the branch is
    chosen by ``"VAE" in network`` (:303). The port takes every registered
    network (the test above)."""
    raw = _write_well(tmp_path, _well_patches(3, 2, 32))
    config = JaxPC(latent_encoding=JaxLE(**_le(name, tmp_path / "w")))
    with pytest.raises(error, match=match):
        jax_patch_vae.process_vae(str(raw), str(tmp_path / "supp"), SITES,
                                  config)


@pytest.mark.parametrize("name", sorted(NETS))
def test_model_pt_of_every_family_loads(name, tmp_path):
    """Fault 2 of the JAX package: it imports a torch model.pt for the
    VQ-VAEs only (dynamorph_tpu/pipeline/patch_vae.py:206-226). The port
    loads one of every family, strict."""
    jcls, tcls = NETS[name]
    torch.manual_seed(2)
    src = tcls(**KW)
    path = str(tmp_path / "model.pt")
    torch.save(src.state_dict(), path)
    with pytest.raises(ValueError, match="No torch importer"):
        jax_patch_vae._load_model_weights(jcls(**KW), path)
    dst = _load_model_weights(tcls(**KW), path)
    for k, v in src.state_dict().items():
        assert torch.equal(v, dst.state_dict()[k]), k


def _training_config(root, name, n=12):
    from test_torch_train import _relations

    raw = root / "train_raw"
    raw.mkdir(parents=True)
    save_pickle(_well_patches(4, n, 32),
                str(raw / "im_static_patches.pkl"))
    save_pickle(np.arange(n), str(raw / "im_static_patches_labels.pkl"))
    rel = {k: v for k, v in _relations().items()
           if max(k) < n}
    save_pickle(rel, str(raw / "im_static_patches_relations.pkl"))
    cfg = root / "train.yml"
    cfg.write_text(
        "training:\n"
        f"  raw_dirs: ['{raw}']\n  supp_dirs: ['{root / 'supp'}']\n"
        f"  weights_dirs: ['{root / 'out'}']\n  network: '{name}'\n"
        + "".join(f"  {k}: {v}\n" for k, v in KW.items())
        + "  num_embeddings: 16\n  n_epochs: 1\n  learn_rate: 0.0001\n"
        "  batch_size: 8\n  val_split_ratio: 0.25\n  model_name: 'm'\n")
    return cfg


@pytest.mark.parametrize("name", sorted(NETS))
def test_run_training_then_process_loads_its_model_pt(name, tmp_path):
    """``run_training --device cpu`` trains each network for one epoch
    and writes model.pt; ``run_vae -m process`` loads it strict and
    encodes the well."""
    cfg = _training_config(tmp_path, name)
    model, hist = run_training.main(["-c", str(cfg), "--device", "cpu"])
    assert type(model) is NETS[name][1] and [h["epoch"] for h in hist] == [0]
    assert all(np.isfinite(v) for split in ("train", "val")
               for v in hist[0][split].values())
    if name != "AAE":
        assert "KLD" in hist[0]["train"] or name == "IWAE"
    out = tmp_path / "out" / "m"
    sd = load_reference_checkpoint(str(out / "model.pt"))
    raw = _write_well(tmp_path, _well_patches(5, 3, 32))
    pcfg = _process_config(tmp_path, name, out, raw)
    run_vae.main(["-m", "process", "-c", str(pcfg), "--device", "cpu"])
    z = load_pickle(str(raw / "m" / f"{WELL}_latent_space.pkl"))
    fresh = NETS[name][1](**KW)
    fresh.load_state_dict(sd, strict=True)
    x = zscore_patch(_well_patches(5, 3, 32)[:, :, 0]).astype(np.float32)
    want = fresh.encode(torch.from_numpy(x))[0].reshape(3, -1).numpy()
    _close(z, want, "process of the trained model.pt")
