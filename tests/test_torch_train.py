"""The port's VQ-VAE training (models in train mode, steps, data utilities,
trainer, checkpoints, ``run_training``) against the JAX package.

Inputs come from numpy seeds; weights are drawn with numpy on the JAX
package's tree (``test_torch_vae_family.numpy_weights``: ``jax.eval_shape``
of ``init``, so no init program compiles) and carried over with
``state_dict_from_jax``. Tolerances, with their reasons:

- one train-mode step (``apply(train=True)`` and its gradient): losses
  rtol 1e-5; gradients rtol 1e-3 with atol 1e-5 of the tensor's largest
  JAX gradient, floored at 1e-3 of the model's largest (fp32 summation
  order, XLA-CPU vs oneDNN, measured about 1e-6 relative; a small gradient
  that sums large cancelling terms keeps their rounding). The biases of convolutions that feed a batch norm have an
  exact gradient of 0: both sides must stay below 1e-5 of the model's
  largest gradient. Batch-norm running buffers after the step atol 1e-6
  (the JAX package's one-pass statistics against torch's two passes,
  BASELINE.md:287-297; measured 6e-8).
- ``train_vqvae`` histories: train losses rtol 1e-5 (measured 9e-7). Val
  losses rtol 2e-3 (measured 5e-4): Adam turns the rounding noise on the
  zero-gradient biases above into steps of about lr, which train-mode batch
  norm removes but the running statistics of the val steps do not. That is
  also why parameters after Adam are not compared element by element
  (tests/test_training.py:53-55).
"""
import os
import shutil

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

from dynamorph_tpu.models import VQVAEz16 as JaxZ16, VQVAEz32 as JaxZ32
from dynamorph_tpu.train import data as jdata
from dynamorph_tpu.train.steps import _dihedral as jax_dihedral
from dynamorph_tpu.train import trainer as jax_trainer
from dynamorph_tpu.train.trainer import train_vqvae as jax_train_vqvae
from dynamorph_tpu_torch.cli import run_training, run_vae
from dynamorph_tpu_torch.io.pickles import load_pickle, save_pickle
from dynamorph_tpu_torch.models import VQVAEz16, VQVAEz32
from dynamorph_tpu_torch.models.jax_import import (load_reference_checkpoint,
                                                   state_dict_from_jax)
from dynamorph_tpu_torch.pipeline.patch_vae import encode_patches
from dynamorph_tpu_torch.train import checkpoint, data as tdata
from dynamorph_tpu_torch.train import trainer as trainer_mod
from dynamorph_tpu_torch.train.steps import augment_batch
from dynamorph_tpu_torch.train.trainer import train_vqvae

# the loss weights of configs/config_example.yml:75-113
LOSS_W = dict(weight_matching=100.0, margin=1.0, w_a=1.0, w_t=0.5, w_n=-0.5)
NETS = {"z16": (JaxZ16, VQVAEz16, "VQ_VAE_z16"),
        "z32": (JaxZ32, VQVAEz32, "VQ_VAE_z32")}
STEP_KW = dict(num_hiddens=16, num_residual_hiddens=8, num_embeddings=32,
               **LOSS_W)
TRAIN_KW = dict(num_hiddens=8, num_residual_hiddens=8, num_embeddings=16,
                **LOSS_W)


def _pre_bn_biases(model: nn.Module):
    """Names of conv biases that feed a batch norm directly: their exact
    gradient is 0 in train mode. z16's fused stem composes enc.0 and enc.1,
    so only enc.1 feeds the first batch norm."""
    names = set()
    for prefix, mod in model.named_modules():
        if isinstance(mod, nn.Sequential):
            for i in range(len(mod) - 1):
                if isinstance(mod[i], (nn.Conv2d, nn.ConvTranspose2d)) and \
                        isinstance(mod[i + 1], nn.BatchNorm2d):
                    names.add(f"{prefix}.{i}.bias")
    return names


def _numpy_weights(jmodel, seed):
    # imported here: test_torch_vae_family imports this module
    from test_torch_vae_family import numpy_weights

    return numpy_weights(jmodel, seed)


def _step_inputs(seed=5):
    r = np.random.RandomState(seed)
    x = r.randn(8, 2, 32, 32).astype(np.float32)
    mask = (r.rand(8, 2, 32, 32) > 0.3).astype(np.float32)
    rel = r.randint(0, 3, (8, 8)).astype(np.uint8)
    return x, mask, rel


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two intra-op threads for a module's CPU work: the suite runs six
    workers on the machine's cores, and torch's default of one thread a
    core in each of them oversubscribes the machine (oneDNN thrashes: the
    ResNet file took 15x its lone time under six workers). The port's
    other test modules bind this fixture by importing it."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module", params=sorted(NETS))
def step_pair(request):
    """One train-mode forward and backward through both packages on the
    same weights, batch, mask and relation block."""
    jcls, tcls, network = NETS[request.param]
    jmodel = jcls(vq_impl="xla", **STEP_KW)
    params, state = _numpy_weights(jmodel, seed=3)
    x, mask, rel = _step_inputs()

    def loss_fn(p, s, x, rel, mask):
        _, losses, new_state = jmodel.apply(
            p, s, x, train=True, time_matching_mat=rel, batch_mask=mask)
        return losses["total_loss"], (losses, new_state)

    (_, (losses_j, new_state)), grads_j = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(
        params, state, jnp.asarray(x), jnp.asarray(rel, jnp.float32),
        jnp.asarray(mask))
    losses_j, new_state, grads_j = jax.device_get(
        (losses_j, new_state, grads_j))

    model = tcls(**STEP_KW)
    model.load_state_dict(state_dict_from_jax(params, state, network),
                          strict=True)
    _, losses = model.apply(torch.from_numpy(x), train=True,
                            time_matching_mat=rel,
                            batch_mask=torch.from_numpy(mask))
    losses["total_loss"].backward()
    return dict(model=model, losses=losses, losses_j=losses_j,
                grads_j=state_dict_from_jax(grads_j, state, network),
                state_j=state_dict_from_jax(params, new_state, network))


def test_train_apply_losses_match_jax(step_pair):
    losses, losses_j = step_pair["losses"], step_pair["losses_j"]
    assert set(losses) == set(losses_j)
    for k in losses:
        np.testing.assert_allclose(float(losses[k].detach()),
                                   float(losses_j[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    assert float(losses["perplexity"]) > 4          # a real lookup
    assert float(losses["time_matching_loss"].detach()) > 0


def test_train_apply_gradients_match_jax(step_pair):
    model, grads_j = step_pair["model"], step_pair["grads_j"]
    named = dict(model.named_parameters())
    assert set(named) == {k for k in grads_j
                          if "running" not in k and "num_batches" not in k
                          and k != "channel_var"}
    scale = max(float(np.abs(g.numpy()).max()) for g in grads_j.values())
    zero = _pre_bn_biases(model)
    assert zero
    for name, p in named.items():
        g, g_j = p.grad.numpy(), grads_j[name].numpy()
        if name in zero:
            assert np.abs(g).max() <= 1e-5 * scale, name
            assert np.abs(g_j).max() <= 1e-5 * scale, name
        else:
            np.testing.assert_allclose(
                g, g_j, rtol=1e-3,
                atol=1e-5 * max(np.abs(g_j).max(), 1e-3 * scale),
                err_msg=name)
    assert np.abs(named["vq.w.weight"].grad.numpy()).max() > 0


def test_train_apply_bn_buffers_match_jax_new_state(step_pair):
    """The port's running buffers after apply(train=True) are the JAX
    package's new_state (carried into reference names by the weight
    bridge); num_batches_tracked has no JAX counterpart."""
    model, state_j = step_pair["model"], step_pair["state_j"]
    n = 0
    for name, buf in model.named_buffers():
        if "running_" in name:
            np.testing.assert_allclose(buf.numpy(), state_j[name].numpy(),
                                       rtol=0, atol=1e-6, err_msg=name)
            n += 1
        elif name.endswith("num_batches_tracked"):
            assert int(buf) == 1
    assert n >= 8
    assert not model.training            # the call left the module's mode


# ---------------------------------------------------------------- modes


def test_module_mode_changes_no_result(rng):
    """apply's ``train`` flag decides batch norm, not model.train() /
    model.eval(): encode, decode and eval apply give the same values in
    either mode, eval apply leaves the buffers alone, and every call leaves
    the module's mode as it found it."""
    model = VQVAEz32(**TRAIN_KW)
    x = torch.from_numpy(rng.randn(4, 2, 32, 32).astype(np.float32))
    model.train()                            # update the running stats once
    model.apply(x, train=True)
    model.eval()
    ref_enc = model.encode(x)
    ref_dec = model.decode(ref_enc[0])
    ref_apply = model.apply(x)[1]["total_loss"]
    before = {k: v.clone() for k, v in model.state_dict().items()}
    model.train()
    for a, b in zip(model.encode(x), ref_enc):
        assert torch.equal(a, b)
    assert torch.equal(model.decode(ref_enc[0]), ref_dec)
    assert torch.equal(model.apply(x)[1]["total_loss"], ref_apply)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert all(m.training for m in model.modules())
    model.eval()
    model.apply(x, train=True)
    assert not any(m.training for m in model.modules())
    assert not torch.equal(model.enc[1].running_mean,
                           before["enc.1.running_mean"])


def test_vq_train_precision_is_checked():
    assert VQVAEz32(vq_train_precision="highest").vq_train_precision == \
        "highest"
    with pytest.raises(ValueError, match="vq_train_precision"):
        VQVAEz32(vq_train_precision="bf16")


# ---------------------------------------------------------------- augment


def test_augment_matches_jax_dihedral(rng):
    """Every (flip, rot) pair, injected, equals JAX's per-image _dihedral,
    and the uint8 mask moves with its image."""
    flips = np.repeat(np.arange(3), 4).astype(np.int32)
    rots = np.tile(np.arange(4), 3).astype(np.int32)
    batch = rng.randn(12, 2, 8, 8).astype(np.float32)
    mask = (rng.rand(12, 1, 8, 8) > 0.5).astype(np.uint8)
    out, out_mask = augment_batch(torch.from_numpy(batch),
                                  torch.from_numpy(mask),
                                  flips=torch.from_numpy(flips),
                                  rots=torch.from_numpy(rots))
    vm = jax.vmap(jax_dihedral)
    ref = vm(jnp.asarray(batch), jnp.asarray(flips), jnp.asarray(rots))
    ref_mask = vm(jnp.asarray(mask), jnp.asarray(flips), jnp.asarray(rots))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert out_mask.dtype == torch.uint8
    np.testing.assert_array_equal(out_mask.numpy(), np.asarray(ref_mask))
    # torch.rot90 and np/jnp.rot90 share one convention
    np.testing.assert_array_equal(
        torch.rot90(torch.from_numpy(batch[0]), 1, (1, 2)).numpy(),
        np.rot90(batch[0], 1, axes=(1, 2)))


def test_augment_draws_from_generator(rng):
    batch = torch.from_numpy(rng.randn(16, 2, 8, 8).astype(np.float32))
    mask = (batch[:, :1] > 0).to(torch.uint8)
    a, ma = augment_batch(batch, mask,
                          generator=torch.Generator().manual_seed(4))
    b, mb = augment_batch(batch, mask,
                          generator=torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and torch.equal(ma, mb)
    assert torch.equal(ma, (a[:, :1] > 0).to(torch.uint8))  # moved together
    assert not torch.equal(a, batch)
    for i in range(16):                      # a permutation of each image
        assert torch.equal(torch.sort(a[i].flatten())[0],
                           torch.sort(batch[i].flatten())[0])


# ---------------------------------------------------------------- data


def _relations():
    """Four trajectories of five frames (2: adjacent, 1: same trajectory)
    among 24 patches."""
    rel = {}
    for t in range(4):
        frames = range(t * 5, t * 5 + 5)
        for a in frames:
            for b in frames:
                if a != b:
                    rel[(a, b)] = 2 if abs(a - b) == 1 else 1
    return rel


def test_reorder_and_concat_match_jax(rng):
    data = rng.randn(24, 3).astype(np.float32)
    ds, rel, order = tdata.reorder_with_trajectories(data, _relations(), 7)
    ds_j, rel_j, order_j = jdata.reorder_with_trajectories(
        data, _relations(), 7)
    assert order == order_j
    np.testing.assert_array_equal(ds, ds_j)
    np.testing.assert_array_equal(rel.toarray(), rel_j.toarray())
    labels = [np.arange(24), np.arange(10)]
    merged, lab = tdata.concat_relations([_relations(), {(0, 1): 2}], labels,
                                         [0, 24])
    merged_j, lab_j = jdata.concat_relations([_relations(), {(0, 1): 2}],
                                             labels, [0, 24])
    assert merged == merged_j
    np.testing.assert_array_equal(lab, lab_j)


@pytest.mark.parametrize("ratio,shuffle", [(0.15, False), (0.25, True),
                                           (None, False)])
def test_splits_match_jax(rng, ratio, shuffle):
    ids = tdata.split_data_ids(40, ratio, shuffle, np.random.RandomState(3))
    ids_j = jdata.split_data_ids(40, ratio, shuffle, np.random.RandomState(3))
    assert ids == ids_j
    if ratio is not None:
        ds, labels = rng.randn(40, 2), np.arange(40)
        for a, b in zip(tdata.train_val_split(ds, labels, ratio, seed=3),
                        jdata.train_val_split(ds, labels, ratio, seed=3)):
            np.testing.assert_array_equal(a, b)


def test_slices_and_normalisation_match_jax(rng):
    _, rel, _ = tdata.reorder_with_trajectories(np.zeros(24), _relations(), 1)
    ids = [3, 4, 5, 11, 20]
    block = tdata.slice_relation_mat(rel, ids)
    assert block.dtype == np.uint8
    np.testing.assert_array_equal(block, jdata.slice_relation_mat(rel, ids))
    assert tdata.slice_relation_mat(None, ids) is None
    mask = np.where(rng.rand(24, 2, 4, 4) > 0.5, 1.0, -1.0)
    m = tdata.slice_mask(mask, ids)
    assert m.dtype == np.uint8 and m.shape == (5, 1, 4, 4)
    np.testing.assert_array_equal(m, jdata.slice_mask(mask, ids))
    raw = rng.rand(6, 3, 8, 8) * 65535
    np.testing.assert_array_equal(tdata.zscore(raw), jdata.zscore(raw))
    np.testing.assert_array_equal(
        tdata.zscore(raw, [1.0, 2.0, 3.0], [4.0, 5.0, 6.0]),
        jdata.zscore(raw, [1.0, 2.0, 3.0], [4.0, 5.0, 6.0]))
    np.testing.assert_array_equal(tdata.zscore_patch(raw),
                                  jdata.zscore_patch(raw))
    np.testing.assert_array_equal(tdata.vae_preprocess(raw, (0, 1, 2)),
                                  jdata.vae_preprocess(raw, (0, 1, 2)))
    np.testing.assert_array_equal(tdata.unzscore(raw, 2.0, 3.0),
                                  jdata.unzscore(raw, 2.0, 3.0))


# ---------------------------------------------------------------- trainer


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """train_vqvae of both packages from the same numpy weights: 28 patches
    with a mask and four trajectories, batch 10, 2 epochs, no augmentation,
    the published lr 1e-4. 28 patches split into 24 to train (batches of
    10, 10 and 4: a ragged last batch, so the epoch mean is one over
    batches) and 4 to validate; the JAX side compiles two train programs
    and one eval program. The port runs on the CPU."""
    root = tmp_path_factory.mktemp("train")
    r = np.random.RandomState(0)
    data = r.randn(28, 2, 32, 32).astype(np.float32)
    mask = np.where(r.rand(28, 2, 32, 32) > 0.5, 1.0, -1.0)
    ds, rel, order = tdata.reorder_with_trajectories(data, _relations(), 0)
    mask = mask[order]
    jmodel = JaxZ32(vq_impl="xla", **TRAIN_KW)
    params, state = _numpy_weights(jmodel, seed=1)
    kw = dict(relation_mat=rel, mask=mask, n_epochs=2, batch_size=10,
              patience=5, transform=False, lr=1e-4)
    with pytest.MonkeyPatch.context() as mp:
        # the JAX side's orbax checkpoints are never read here
        mp.setattr(jax_trainer, "save_checkpoint", lambda *a, **k: None)
        _, _, hist_j = jax_train_vqvae(jmodel, ds, str(root / "jax"),
                                       params=params, state=state, **kw)
    init = state_dict_from_jax(params, state, "VQ_VAE_z32")
    model = VQVAEz32(**TRAIN_KW)
    model.load_state_dict(init)
    out = str(root / "port")
    _, hist = train_vqvae(model, ds, out, device="cpu", **kw)
    return dict(ds=ds, kw=kw, init=init, hist=hist, hist_j=hist_j, out=out,
                model=model, root=root)


def test_train_vqvae_history_matches_jax(trained):
    hist, hist_j = trained["hist"], trained["hist_j"]
    assert [h["epoch"] for h in hist] == [h["epoch"] for h in hist_j] == [0, 1]
    for h, h_j in zip(hist, hist_j):
        for split, rtol in (("train", 1e-5), ("val", 2e-3)):
            assert set(h[split]) == set(h_j[split])
            for k in h[split]:
                np.testing.assert_allclose(h[split][k], h_j[split][k],
                                           rtol=rtol, err_msg=(split, k))


def test_train_vqvae_writes_checkpoint_and_metrics(trained):
    out = trained["out"]
    assert {"model.pt", "train_state.pt", "metrics.jsonl"} <= set(
        os.listdir(out))
    lines = open(os.path.join(out, "metrics.jsonl")).read().splitlines()
    assert len(lines) == 4                   # Loss and Val loss per epoch
    sd = load_reference_checkpoint(os.path.join(out, "model.pt"))
    assert "vq.w.weight" in sd and "dec.2.running_var" in sd
    fresh = VQVAEz32(**TRAIN_KW)
    assert checkpoint.restore_checkpoint(out, fresh) is None
    assert all(np.isfinite(v) for h in trained["hist"]
               for split in ("train", "val") for v in h[split].values())


def test_train_vqvae_resident_and_streamed_feeds_agree(trained, monkeypatch):
    monkeypatch.setattr(trainer_mod, "_DEVICE_RESIDENT_BUDGET", 0)
    model = VQVAEz32(**TRAIN_KW)
    model.load_state_dict(trained["init"])
    _, hist = train_vqvae(model, trained["ds"],
                          str(trained["root"] / "streamed"), device="cpu",
                          **trained["kw"])
    for a, b in zip(hist, trained["hist"]):
        for split in ("train", "val"):
            for k in a[split]:
                assert a[split][k] == pytest.approx(b[split][k], rel=1e-6)


def test_train_vqvae_resume_continues_at_next_epoch(trained):
    """resume restores the best epoch's weights, optimizer state and epoch
    (as the JAX package restores its best checkpoint) and goes on from the
    epoch after it."""
    out = str(trained["root"] / "resume")
    shutil.copytree(trained["out"], out)
    saved = torch.load(os.path.join(out, "train_state.pt"),
                       weights_only=True)
    best = min(trained["hist"], key=lambda h: h["val"]["total_loss"])
    assert saved["epoch"] == best["epoch"]
    assert saved["optimizer"]["state"]          # Adam moments were saved
    kw = dict(trained["kw"], n_epochs=3)
    _, hist = train_vqvae(VQVAEz32(**TRAIN_KW), trained["ds"], out,
                          device="cpu", resume=True, **kw)
    assert [h["epoch"] for h in hist] == list(range(saved["epoch"] + 1, 3))
    assert np.isfinite(hist[0]["val"]["total_loss"])


def test_trained_model_pt_round_trips_into_run_vae(trained, tmp_path):
    """The trainer's model.pt is the weights file that run_vae -m process
    loads (weights: <training output dir>)."""
    raw = tmp_path / "raw"
    r = np.random.RandomState(2)
    data = r.rand(5, 2, 1, 32, 32) * 65535.0
    save_pickle([f"/s/C5-supps/C5-Site_0/{i}_{i}.h5" for i in range(5)],
                str(raw / "C5_file_paths.pkl"))
    save_pickle(data, str(raw / "C5_static_patches.pkl"))
    cfg = tmp_path / "cfg.yml"
    cfg.write_text(
        "latent_encoding:\n"
        f"  raw_dirs: ['{raw}']\n  supp_dirs: ['{tmp_path / 'supp'}']\n"
        f"  weights: ['{trained['out']}']\n  fov: ['C5-Site_0']\n"
        "  save_output: False\n  network: 'VQ_VAE_z32'\n"
        "  num_hiddens: 8\n  num_residual_hiddens: 8\n"
        "  num_embeddings: 16\n")
    run_vae.main(["-m", "process", "-c", str(cfg), "--device", "cpu"])
    z_b = load_pickle(str(raw / "port" / "C5_latent_space.pkl"))
    model = VQVAEz32(**TRAIN_KW)
    model.load_state_dict(
        load_reference_checkpoint(os.path.join(trained["out"], "model.pt")))
    ref, _ = encode_patches(model, data[:, :, 0], 5, normalize="patch",
                            device="cpu")
    assert z_b.shape == (5, 8 * 8 * 8)      # z32: 32x32 in, 8x8 latents
    np.testing.assert_allclose(z_b, ref, atol=1e-5)


def test_train_vqvae_shuffled_and_saved_each_epoch(trained, tmp_path):
    """shuffle_data draws the split from shuffled ids (split_data_ids, held
    against JAX above) and reshuffles between epochs; save_every_epoch
    writes model_epoch<e>/model.pt."""
    model = VQVAEz32(**TRAIN_KW)
    model.load_state_dict(trained["init"])
    kw = dict(trained["kw"], shuffle_data=True)
    _, hist = train_vqvae(model, trained["ds"], str(tmp_path), device="cpu",
                          save_every_epoch=True, **kw)
    for e in (0, 1):
        assert (tmp_path / f"model_epoch{e}" / "model.pt").exists()
    assert all(np.isfinite(v) for h in hist for split in ("train", "val")
               for v in h[split].values())
    assert hist[0]["train"]["total_loss"] != \
        trained["hist"][0]["train"]["total_loss"]


def test_train_entry_points_refuse_cpu_unless_asked(trained, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_vqvae(VQVAEz32(**TRAIN_KW), trained["ds"], str(tmp_path))


# ---------------------------------------------------------------- CLI


def _training_dir(root, n=24, use_mask=False, network="VQ_VAE_z16",
                  extra=""):
    """A raw dir with im_static_patches (N, 2, 1, 32, 32), labels and
    relations, and its training config."""
    raw = root / "raw"
    raw.mkdir(parents=True)
    r = np.random.RandomState(0)
    patches = r.rand(n, 2, 1, 32, 32) * 65535.0
    save_pickle(patches, str(raw / "im_static_patches.pkl"))
    save_pickle(np.arange(n), str(raw / "im_static_patches_labels.pkl"))
    save_pickle(_relations(), str(raw / "im_static_patches_relations.pkl"))
    if use_mask:
        # the mask marks the bright half of channel 1 of its own patch
        m = np.where(patches > 0.5 * 65535.0, 1.0, -1.0)
        save_pickle(m[:, :, 0], str(raw / "im_static_patches_mask.pkl"))
    cfg = root / "cfg.yml"
    cfg.write_text(
        "training:\n"
        f"  raw_dirs: ['{raw}']\n  supp_dirs: ['{root / 'supp'}']\n"
        f"  weights_dirs: ['{root / 'weights'}']\n"
        f"  network: '{network}'\n  num_hiddens: 8\n"
        "  num_residual_hiddens: 8\n  num_embeddings: 16\n"
        "  weight_matching: 100\n  margin: 1\n  w_a: 1\n  w_t: 0.5\n"
        "  w_n: -0.5\n  n_epochs: 2\n  learn_rate: 0.0001\n"
        "  batch_size: 8\n  val_split_ratio: 0.15\n  model_name: 'vq'\n"
        f"  use_mask: {use_mask}\n" + extra)
    return raw, cfg


def test_run_training_cli_on_synthetic_dir(tmp_path):
    _, cfg = _training_dir(tmp_path)
    model, hist = run_training.main(["-c", str(cfg), "--device", "cpu"])
    out = tmp_path / "weights" / "vq"
    assert {"model.pt", "train_state.pt", "metrics.jsonl"} <= set(
        os.listdir(out))
    assert [h["epoch"] for h in hist] == [0, 1]
    assert all(np.isfinite(h["train"]["total_loss"]) for h in hist)
    assert isinstance(model, VQVAEz16) and model.vq_train_precision == "high"
    fresh = VQVAEz16(num_hiddens=8, num_residual_hiddens=8, num_embeddings=16)
    fresh.load_state_dict(load_reference_checkpoint(str(out / "model.pt")),
                          strict=True)
    # start_model_path: the run's own output directory (holding model.pt)
    # seeds a second run; retrain starts the epochs anew
    extra = f"  start_model_path: '{out}'\n  retrain: True\n"
    _, cfg2 = _training_dir(tmp_path / "again", extra=extra)
    _, hist2 = run_training.main(["-c", str(cfg2), "--device", "cpu"])
    assert [h["epoch"] for h in hist2] == [0, 1]


def test_run_training_reorders_the_mask_with_its_patches(tmp_path,
                                                         monkeypatch):
    """The patches are reordered by trajectory; the mask must follow them.
    (The JAX package's CLI reorders the patches and labels but not the
    mask, dynamorph_tpu/cli/run_training.py:65-73.)"""
    _, cfg = _training_dir(tmp_path, use_mask=True)
    seen = {}
    monkeypatch.setattr(run_training, "train_vqvae",
                        lambda model, ds, out, **kw: seen.update(ds=ds, **kw))
    run_training.main(["-c", str(cfg), "--device", "cpu"])
    ds, mask = seen["ds"], seen["mask"]
    raw = load_pickle(str(tmp_path / "raw" / "im_static_patches.pkl"))[:, :, 0]
    # z-scoring is increasing per channel, so the bright half stays bright
    thresh = (0.5 * 65535.0 - raw[:, 1].mean()) / raw[:, 1].std()
    np.testing.assert_array_equal(mask[:, 1] > 0, ds[:, 1] > thresh)
    assert not np.array_equal(ds, tdata.zscore(raw).astype(np.float32))


def test_run_training_refuses_what_is_not_ported(tmp_path):
    """An orbax checkpoint directory as ``start_model_path`` (the JAX
    package's format, which the port does not read) is refused on both
    branches: the VQ-VAE family and, since the ResNet branch is ported,
    ResNet50."""
    orbax_dir = tmp_path / "orbax_ckpt"
    orbax_dir.mkdir()
    for network in ("VQ_VAE_z16", "ResNet50"):
        _, cfg = _training_dir(tmp_path / network, network=network,
                               extra=f"  start_model_path: '{orbax_dir}'\n")
        with pytest.raises(ValueError, match="orbax"):
            run_training.main(["-c", str(cfg), "--device", "cpu"])
