"""The port's ResNet/SimCLR branch (``EncodeProject``, the triplet miners,
``train/triplet_data.py``, ``make_triplet_steps``, ``train_triplet``,
``run_training`` and ``run_vae -m process`` with a ResNet) against the JAX
package.

Weights are drawn with numpy on the JAX package's tree
(``test_torch_vae_family.numpy_weights``: no init program is compiled),
batch norm off the identity. One ResNet50 runs the forward and the
``process`` CLI at 32 x 32; ResNet18 runs everything that trains (at 16 x
16 where only the mechanics are checked). Tolerances, with
their reasons:

- encoder features and projections: max-abs 1e-4 of the largest value
  (fp32 convolution summation order, XLA-CPU vs oneDNN);
- miners: loss rtol 1e-6 (the same fp32 operations on a (B, 8) Gram
  matrix), the positive fraction exactly;
- one train-mode step: losses rtol 1e-5; gradients against the same step
  in float64, per tensor the port's error at most 3 x the JAX package's
  plus 1e-6 of the model's largest gradient (as
  tests/test_torch_vae_family.py); batch-norm buffers atol 1e-6 and rtol
  1e-5 (the JAX package's one-pass statistics against torch's two passes:
  measured 1.2e-6 relative on a running variance near 1);
- ``train_triplet`` histories, at lr 1e-6: the first epoch's train losses
  rtol 1e-5; later values rtol 2e-3 (Adam turns rounding on small
  gradients into steps of about lr, as tests/test_torch_train.py notes),
  and the positive fraction within 0.01 (``ONE_TRIPLET``). The loss is a
  mean over the triplets whose hinge is positive, so it jumps when one
  crosses 0: at the published lr 1e-4 those steps moved one of the
  3 x 72 triplets across, and the epoch's train losses came 2% apart;
- host data (augmentation, positive sets, batches, splits): exactly.
"""
import copy
import shutil
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dynamorph_tpu.cli import run_training as jax_run_training
from dynamorph_tpu.models import losses as jlosses
from dynamorph_tpu.models import resnet_simclr as jresnet
from dynamorph_tpu.models.torch_import import import_encode_project
from dynamorph_tpu.train import triplet_data as jtd
from dynamorph_tpu.train.data import zscore_patch
from dynamorph_tpu.train import trainer as jax_trainer
from dynamorph_tpu.train.trainer import train_triplet as jax_train_triplet
from dynamorph_tpu_torch.cli import run_training, run_vae
from dynamorph_tpu_torch.io.pickles import load_pickle, save_pickle
from dynamorph_tpu_torch.models import losses as tlosses
from dynamorph_tpu_torch.models.jax_import import (load_reference_checkpoint,
                                                   state_dict_from_jax)
from dynamorph_tpu_torch.models.resnet_simclr import (EncodeProject,
                                                      LogisticRegression)
from dynamorph_tpu_torch.train import triplet_data as ttd
from dynamorph_tpu_torch.train.steps import make_triplet_steps
from dynamorph_tpu_torch.train.trainer import train_triplet
from test_torch_vae_family import numpy_weights
from test_torch_train import _few_threads  # noqa: F401

ATOL = 1e-4                             # of the largest value
GRAD_VS_JAX, GRAD_FLOOR = 3.0, 1e-6
# the positive fraction counts hinges above 1e-16: a triplet whose hinge
# sits within rounding of 0 counts on one side only (measured: one of a
# step's 72 valid triplets, 0.0046 of an epoch's mean over 3 steps)
ONE_TRIPLET = 0.01
LABELS = np.array([0, 0, 0, 1, 1, 1, 2, 2])


def _close(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, what
    np.testing.assert_allclose(a, b, rtol=0, atol=ATOL * np.abs(b).max(),
                               err_msg=what)


def _port(arch, params, state, **kw):
    model = EncodeProject(arch=arch, **kw)
    model.load_state_dict(state_dict_from_jax(params, state, arch),
                          strict=True)
    return model


def _patches(seed, n, size):
    r = np.random.RandomState(seed)
    raw = r.rand(n, 2, 1, size, size) * 65535.0
    raw[:, 1] *= 0.2
    return raw


# ------------------------------------------------------------ ResNet50

@pytest.fixture(scope="module")
def r50():
    """ResNet50 at 32 x 32, batch 4: h and z through both packages."""
    jmodel = jresnet.EncodeProject(arch="ResNet50")
    params, state = numpy_weights(jmodel, seed=50)
    raw = _patches(0, 4, 32)
    x = zscore_patch(raw[:, :, 0]).astype(np.float32)
    h_j, z_j = jax.device_get(jax.jit(lambda p, s, x: (
        jmodel.encode_fn(p, s, x, "h")[0],
        jmodel.encode_fn(p, s, x, "z")[0]))(params, state, jnp.asarray(x)))
    model = _port("ResNet50", params, state)
    return dict(params=params, state=state, raw=raw, x=x, h_j=h_j, z_j=z_j,
                model=model)


def test_resnet50_encode_matches_jax(r50):
    x = torch.from_numpy(r50["x"])
    h = r50["model"].encode(x, out="h")
    z = r50["model"].encode(x, out="z")
    assert h.shape == (4, 2048) and z.shape == (4, 128)
    _close(h.numpy(), r50["h_j"], "h")
    _close(z.numpy(), r50["z_j"], "z")
    with pytest.raises(ValueError, match='"h" or "z"'):
        r50["model"].encode(x, out="y")


def test_process_resnet50_matches_jax(r50, tmp_path):
    """``run_vae -m process --device cpu`` with network ResNet50: host
    z-score, the projection in batches, ``<well>_latent_space.pkl`` only,
    equal to the JAX package's z of the same patches."""
    weights = tmp_path / "weights"
    weights.mkdir()
    torch.save(r50["model"].state_dict(), str(weights / "model.pt"))
    raw = _write_well(tmp_path, r50["raw"])
    cfg = _process_config(tmp_path, "ResNet50", weights, raw)
    run_vae.main(["-m", "process", "-c", str(cfg), "--device", "cpu"])
    out = raw / "weights"
    assert sorted(p.name for p in out.iterdir()) == ["C5_latent_space.pkl"]
    z = load_pickle(str(out / "C5_latent_space.pkl"))
    assert z.dtype == np.float32
    _close(z, r50["z_j"], "process")


def _leaf_numbered(tree):
    """Each leaf of the JAX tree filled with its own number (a swap of two
    leaves of one shape shows), batch-norm variances positive."""
    leaves, treedef = jax.tree_util.tree_flatten(jax.eval_shape(
        lambda t: t, tree))
    return jax.tree_util.tree_unflatten(treedef, [
        np.full(leaf.shape, i + 1, np.float32)
        for i, leaf in enumerate(leaves)])


@pytest.mark.parametrize("arch", ["ResNet18", "ResNet50", "ResNet101",
                                  "ResNet152"])
def test_weight_bridges_and_encode(arch):
    """``state_dict_from_jax`` loads strict into the port, and the JAX
    package's own importer (``import_encode_project``) reads the port's
    names back to the same tree; each architecture encodes (ResNet18 and
    50 are held against JAX above and below)."""
    torch.manual_seed(0)
    model = EncodeProject(arch=arch)
    x = torch.from_numpy(zscore_patch(_patches(1, 2, 32)[:, :, 0])
                         .astype(np.float32))
    h, z = model.encode(x, out="h"), model.encode(x, out="z")
    assert h.shape == (2, model.encoder_dim) and z.shape == (2, 128)
    assert bool(torch.isfinite(z).all())
    jmodel = jresnet.EncodeProject(arch=arch)
    params, state = _leaf_numbered(jax.eval_shape(jmodel.init,
                                                  jax.random.PRNGKey(0)))
    model.load_state_dict(state_dict_from_jax(params, state, arch),
                          strict=True)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    assert not sd["projection.bn2.bias"].any()
    assert not model.projection.bn2.bias.requires_grad
    back = jax.device_get(import_encode_project(sd, arch))
    flat, _ = jax.tree_util.tree_flatten_with_path((params, state))
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat) == len(flat_back)
    for path, leaf in flat:
        np.testing.assert_array_equal(flat_back[path], leaf,
                                      err_msg=str(path))


# ------------------------------------------------------------ miners

def _miner_inputs(case):
    r = np.random.RandomState(4)
    if case == "tie_free":
        return r.randint(0, 4, 16), r.randn(16, 8).astype(np.float32)
    # integer embeddings with repeated rows: exact distance ties, and at
    # margin 1 hinges that are exactly 0
    base = r.randint(-1, 2, (6, 8)).astype(np.float32)
    return np.repeat(np.arange(3), 4), base[r.randint(0, 6, 12)]


@pytest.mark.parametrize("case", ["tie_free", "tied"])
@pytest.mark.parametrize("margin", [0.5, 1.0])
def test_miners_match_jax(case, margin):
    ids, emb = _miner_inputs(case)
    loss_j, f_j = jax.jit(jlosses.AllTripletMiner(margin=margin).__call__)(
        jnp.asarray(ids), jnp.asarray(emb))
    loss, f_pos = tlosses.AllTripletMiner(margin=margin)(
        torch.from_numpy(ids), torch.from_numpy(emb))
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-6)
    assert float(f_pos) == float(f_j)
    hard_j, none_j = jax.jit(
        jlosses.HardNegativeTripletMiner(margin=margin).__call__)(
        jnp.asarray(ids), jnp.asarray(emb))
    hard, none = tlosses.HardNegativeTripletMiner(margin=margin)(
        ids, torch.from_numpy(emb))
    assert none is None and none_j is None
    np.testing.assert_allclose(float(hard), float(hard_j), rtol=1e-6)
    d = tlosses.pairwise_dist(torch.from_numpy(emb))
    np.testing.assert_array_equal(
        tlosses._triplet_mask(torch.from_numpy(ids)).numpy(),
        np.asarray(jlosses._triplet_mask(jnp.asarray(ids))))
    np.testing.assert_allclose(
        d.numpy(), np.asarray(jax.jit(jlosses.pairwise_dist)(
            jnp.asarray(emb))), rtol=1e-6, atol=1e-6)


def test_logistic_regression_matches_jax():
    r = np.random.RandomState(5)
    x, labels = r.randn(10, 8).astype(np.float32), r.randint(0, 3, 10)
    jmodel = jresnet.LogisticRegression(input_dim=8, n_class=3)
    params, _ = jmodel.init(jax.random.PRNGKey(0))
    model = LogisticRegression(input_dim=8, n_class=3)
    for w in (None, r.randn(8, 3).astype(np.float32)):
        if w is not None:
            params = {"linear": {"weight": jnp.asarray(w),
                                 "bias": jnp.asarray(w[0])}}
            model.linear.weight.data = torch.from_numpy(w.T.copy())
            model.linear.bias.data = torch.from_numpy(w[0].copy())
        z_j, l_j, _ = jmodel.apply(params, {}, jnp.asarray(x),
                                   labels=jnp.asarray(labels))
        z, l = model.apply(torch.from_numpy(x), torch.from_numpy(labels))
        np.testing.assert_allclose(z.detach().numpy(), np.asarray(z_j),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(float(l["total_loss"]),
                                   float(l_j["total_loss"]), rtol=1e-6)
        assert float(l["acc"]) == float(l_j["acc"])


# ------------------------------------------------------------ host data

def test_triplet_data_matches_jax_under_one_seed():
    """augment_img, TripletDataset and triplet_batches on the global
    ``np.random`` (``rng=None``, as run_training builds them) and the
    shuffle's RandomState: one seed gives both packages the same batches."""
    r = np.random.RandomState(6)
    data = r.rand(10, 2, 8, 8).astype(np.float32)
    labels = np.array([0, 0, 0, 1, 1, 1, 2, 2, 3, 3])
    got = {}
    for name, mod in (("jax", jtd), ("port", ttd)):
        np.random.seed(3)
        flips = [mod.augment_img(data[0]) for _ in range(12)]
        ds = mod.TripletDataset(labels, lambda i, m=mod:
                                m.augment_img(data[i]), 3)
        got[name] = flips + [b for batch in mod.triplet_batches(
            ds, 4, shuffle=True, rng=np.random.RandomState(0))
            for b in batch]
    assert len(got["port"]) == 12 + 2 * 3
    for a, b in zip(got["port"], got["jax"]):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------ one step

def _step_inputs(size=32):
    x = zscore_patch(_patches(7, len(LABELS), size)[:, :, 0]).astype(
        np.float32)
    return x, LABELS


@pytest.fixture(scope="module", params=["all", "hard"])
def step_pair(request):
    """One train-mode forward and backward of ResNet18 with each miner
    through both packages, and the port's step in float64."""
    hard = request.param == "hard"
    jmodel = jresnet.EncodeProject(arch="ResNet18", hard_negative=hard)
    params, state = numpy_weights(jmodel, seed=18)
    x, labels = _step_inputs()

    def loss_fn(p):
        _, losses, ns = jmodel.apply(p, state, jnp.asarray(x),
                                     labels=jnp.asarray(labels), train=True)
        return losses["total_loss"], (losses, ns)

    (_, (losses_j, ns_j)), grads_j = jax.device_get(jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params))
    model = _port("ResNet18", params, state, hard_negative=hard)
    model64 = copy.deepcopy(model).double()
    _, losses = model.apply(torch.from_numpy(x), labels, train=True)
    losses["total_loss"].backward()
    _, losses64 = model64.apply(torch.from_numpy(x).double(), labels,
                                train=True)
    losses64["total_loss"].backward()
    return dict(model=model, losses=losses, losses_j=losses_j,
                grads_j=state_dict_from_jax(grads_j, state, "ResNet18"),
                grads64={n: p.grad for n, p in model64.named_parameters()},
                state_j=state_dict_from_jax(params, ns_j, "ResNet18"),
                hard=hard)


def test_triplet_step_losses_match_jax(step_pair):
    losses, losses_j = step_pair["losses"], step_pair["losses_j"]
    assert set(losses) == set(losses_j)
    assert ("positive_triplet" in losses) != step_pair["hard"]
    for k in losses:
        np.testing.assert_allclose(float(losses[k].detach()),
                                   float(losses_j[k]), rtol=1e-5, err_msg=k)


def test_triplet_step_gradients_match_jax(step_pair):
    named = dict(step_pair["model"].named_parameters())
    grads_j = step_pair["grads_j"]
    assert named["projection.bn2.bias"].grad is None
    named.pop("projection.bn2.bias")
    assert set(named) == {k for k in grads_j if "running" not in k and
                          "num_batches" not in k} - {"projection.bn2.bias"}
    scale = max(float(np.abs(g.numpy()).max()) for g in grads_j.values())
    for name, p in named.items():
        g = p.grad.numpy().astype(np.float64)
        g_j = grads_j[name].numpy().astype(np.float64)
        g64 = step_pair["grads64"][name].numpy()
        err, err_j = np.abs(g - g64).max(), np.abs(g_j - g64).max()
        assert err <= GRAD_VS_JAX * err_j + GRAD_FLOOR * scale, \
            (name, err, err_j)


def test_triplet_step_bn_buffers_match_jax(step_pair):
    want = step_pair["state_j"]
    for name, buf in step_pair["model"].named_buffers():
        if "running" in name:
            np.testing.assert_allclose(buf.numpy(), want[name].numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=name)


def test_make_triplet_steps_update_in_place():
    """The train step runs the miner's loss backward and Adam, moves the
    running statistics and leaves the frozen offset at 0; the eval step
    changes nothing."""
    torch.manual_seed(0)
    model = EncodeProject(arch="ResNet18")
    x, labels = _step_inputs(16)
    x = torch.from_numpy(x)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    step, eval_step = make_triplet_steps(model, opt)
    before = copy.deepcopy(model.state_dict())
    losses = eval_step(x, labels)
    assert all(torch.equal(v, model.state_dict()[k])
               for k, v in before.items())
    out = step(x, labels)
    assert set(out) == set(losses) == {"total_loss", "positive_triplet"}
    after = model.state_dict()
    assert not torch.equal(after["convnet.conv1.weight"],
                           before["convnet.conv1.weight"])
    assert not torch.equal(after["convnet.bn1.running_mean"],
                           before["convnet.bn1.running_mean"])
    assert not after["projection.bn2.bias"].any()


# ------------------------------------------------------------ trainer

def _triplet_sets(mod, seed=8):
    r = np.random.RandomState(seed)
    labels = np.repeat(np.arange(4), 3)
    data = zscore_patch(r.rand(12, 2, 16, 16) + labels[:, None, None, None]
                        ).astype(np.float32)
    return (mod.TripletDataset(labels, lambda i: mod.augment_img(data[i]),
                               2),
            mod.TripletDataset(labels[:8],
                               lambda i: mod.augment_img(data[i]), 2))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """train_triplet of both packages from the same numpy weights: 12
    anchors in 4 labels, positive sets of 2, 4 anchors a step, 2 epochs,
    lr 1e-6 (module docstring); augmentation and positives on the global
    np.random, seeded alike."""
    root = tmp_path_factory.mktemp("triplet")
    jmodel = jresnet.EncodeProject(arch="ResNet18")
    params, state = numpy_weights(jmodel, seed=19)
    kw = dict(n_epochs=2, lr=1e-6, batch_size=4, patience=5,
              earlystop_metric="positive_triplet")
    np.random.seed(9)
    with pytest.MonkeyPatch.context() as mp:
        # the JAX side's orbax checkpoints are never read here
        mp.setattr(jax_trainer, "save_checkpoint", lambda *a, **k: None)
        _, _, hist_j = jax_train_triplet(jmodel, *_triplet_sets(jtd),
                                         str(root / "jax"), params=params,
                                         state=state, **kw)
    np.random.seed(9)
    model = _port("ResNet18", params, state)
    out = root / "port"
    _, hist = train_triplet(model, *_triplet_sets(ttd), str(out),
                            device="cpu", **kw)
    return dict(hist=hist, hist_j=hist_j, out=out, params=params,
                state=state, kw=kw, model=model)


def test_train_triplet_history_matches_jax(trained):
    hist, hist_j = trained["hist"], trained["hist_j"]
    assert [h["epoch"] for h in hist] == [h["epoch"] for h in hist_j] == \
        [0, 1]
    for e, (h, h_j) in enumerate(zip(hist, hist_j)):
        for split in ("train", "val"):
            assert set(h[split]) == set(h_j[split])
            rtol = 1e-5 if (e, split) == (0, "train") else 2e-3
            for k in h[split]:
                atol = ONE_TRIPLET if k == "positive_triplet" else 0
                np.testing.assert_allclose(h[split][k], h_j[split][k],
                                           rtol=rtol, atol=atol,
                                           err_msg=(e, split, k))


def test_train_triplet_checkpoint_resume_and_retrain(trained, tmp_path,
                                                     capsys):
    """model.pt and metrics.jsonl are written; a second run finds model.pt
    and continues from it, unless ``retrain``; the hard-negative miner
    has no positive_triplet, so early stopping falls back to total_loss
    with a warning; an empty dataset raises."""
    out = trained["out"]
    assert {"model.pt", "metrics.jsonl"} <= {p.name for p in out.iterdir()}
    assert len((out / "metrics.jsonl").read_text().splitlines()) == 4
    saved = load_reference_checkpoint(str(out / "model.pt"))
    work = tmp_path / "again"
    shutil.copytree(out, work)
    fresh = _port("ResNet18", trained["params"], trained["state"])
    sets = _triplet_sets(ttd)
    kw = dict(trained["kw"], n_epochs=1)
    capsys.readouterr()
    _, hist = train_triplet(fresh, *sets, str(work), device="cpu",
                            log_step_offset=1, **kw)
    assert "Continue training" in capsys.readouterr().out
    assert hist == []
    assert all(torch.equal(v, fresh.state_dict()[k])
               for k, v in saved.items())
    fresh = _port("ResNet18", trained["params"], trained["state"],
                  hard_negative=True)
    with pytest.warns(UserWarning, match="monitors val 'total_loss'"):
        _, hist = train_triplet(fresh, *sets, str(work), device="cpu",
                                retrain=True, **kw)
    assert "Continue training" not in capsys.readouterr().out
    assert "positive_triplet" not in hist[0]["train"]
    empty = ttd.TripletDataset(np.array([], int), lambda i: None, 2)
    with pytest.raises(ValueError, match="no training batches"), \
            warnings.catch_warnings():
        warnings.simplefilter("ignore")
        train_triplet(fresh, empty, empty, str(work / "e"), device="cpu",
                      **kw)


# ------------------------------------------------------------ CLIs

def _write_well(root, raw_patches):
    raw = root / "raw"
    raw.mkdir(parents=True)
    sites = ["C5-Site_0", "C5-Site_1"]
    save_pickle([f"/s/C5-supps/{sites[i % 2]}/{i}_{i}.h5"
                 for i in range(len(raw_patches))],
                str(raw / "C5_file_paths.pkl"))
    save_pickle(raw_patches, str(raw / "C5_static_patches.pkl"))
    return raw


def _process_config(root, network, weights, raw):
    cfg = root / "cfg.yml"
    cfg.write_text(
        "latent_encoding:\n"
        f"  raw_dirs: ['{raw}']\n  supp_dirs: ['{root / 'supp'}']\n"
        f"  weights: ['{weights}']\n  fov: ['C5-Site_0', 'C5-Site_1']\n"
        f"  save_output: False\n  network: '{network}'\n")
    return cfg


def _training_dir(root, n=16, extra=""):
    raw = root / "train_raw"
    raw.mkdir(parents=True)
    save_pickle(_patches(10, n, 16), str(raw / "im_static_patches.pkl"))
    save_pickle(np.arange(n) % 4, str(raw / "im_static_patches_labels.pkl"))
    save_pickle({}, str(raw / "im_static_patches_relations.pkl"))
    cfg = root / "train.yml"
    cfg.write_text(
        "training:\n"
        f"  raw_dirs: ['{raw}']\n  supp_dirs: ['{root / 'supp'}']\n"
        f"  weights_dirs: ['{root / 'out'}']\n  network: 'ResNet18'\n"
        "  n_epochs: 1\n  learn_rate: 0.0001\n  batch_size: 8\n"
        "  n_pos_samples: 2\n  val_split_ratio: 0.25\n  margin: 1\n"
        "  model_name: 'resnet'\n" + extra)
    return cfg


def test_run_training_resnet_builds_the_jax_packages_batches(tmp_path,
                                                              monkeypatch):
    """Both CLIs' ResNet branch, up to the trainer: the same split,
    datasets (the same batches under one np.random seed), anchors a step
    (batch_size / n_pos_samples), margin and epochs."""
    cfg = _training_dir(tmp_path)
    seen = {}

    def capture(name):
        def train(model, tri_train, tri_val, out, **kw):
            seen[name] = (model, tri_train, tri_val, kw)
            return model, []
        return train

    monkeypatch.setattr(jax_run_training, "train_triplet", capture("jax"))
    monkeypatch.setattr(run_training, "train_triplet", capture("port"))
    monkeypatch.setattr("dynamorph_tpu.core.compile_cache."
                        "enable_persistent_cache", lambda: None)
    jax_run_training.main(str(cfg))
    run_training.main(["-c", str(cfg), "--device", "cpu"])
    (jm, jtr, jva, jkw), (tm, ttr, tva, tkw) = seen["jax"], seen["port"]
    assert (tm.arch, tm.margin, tm.num_inputs) == \
        (jm.arch, jm.margin, jm.num_inputs) == ("ResNet18", 1.0, 2)
    assert tkw["batch_size"] == jkw["batch_size"] == 4
    for k in ("n_epochs", "lr", "patience", "earlystop_metric", "retrain",
              "log_step_offset"):
        assert tkw[k] == jkw[k], k
    for t_set, j_set in ((ttr, jtr), (tva, jva)):
        np.testing.assert_array_equal(t_set.labels, j_set.labels)
        batches = {}
        for name, s, mod in (("jax", j_set, jtd), ("port", t_set, ttd)):
            np.random.seed(1)
            batches[name] = list(mod.triplet_batches(
                s, 4, shuffle=True, rng=np.random.RandomState(0)))
        for (la, da), (lb, db) in zip(batches["port"], batches["jax"]):
            np.testing.assert_array_equal(la, lb)
            np.testing.assert_array_equal(da, db)


def test_run_training_resnet_then_process(tmp_path):
    """``run_training --device cpu`` trains ResNet18 for an epoch and
    writes model.pt; ``start_model_path`` seeds a second run from it;
    ``run_vae -m process`` loads it strict and writes the projections."""
    cfg = _training_dir(tmp_path)
    model, hist = run_training.main(["-c", str(cfg), "--device", "cpu"])
    assert isinstance(model, EncodeProject) and model.arch == "ResNet18"
    assert [h["epoch"] for h in hist] == [0]
    out = tmp_path / "out" / "resnet"
    sd = load_reference_checkpoint(str(out / "model.pt"))
    again = _training_dir(tmp_path / "again", extra=(
        f"  start_model_path: '{out}'\n  retrain: True\n"))
    model2, _ = run_training.main(["-c", str(again), "--device", "cpu"])
    assert isinstance(model2, EncodeProject)
    raw_patches = _patches(11, 3, 16)
    raw = _write_well(tmp_path, raw_patches)
    pcfg = _process_config(tmp_path, "ResNet18", out, raw)
    run_vae.main(["-m", "process", "-c", str(pcfg), "--device", "cpu"])
    z = load_pickle(str(raw / "resnet" / "C5_latent_space.pkl"))
    fresh = EncodeProject(arch="ResNet18")
    fresh.load_state_dict(sd, strict=True)
    x = torch.from_numpy(zscore_patch(raw_patches[:, :, 0])
                         .astype(np.float32))
    np.testing.assert_array_equal(z, fresh.encode(x).numpy())
