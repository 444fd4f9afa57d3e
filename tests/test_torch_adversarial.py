"""The port's AAE adversarial training (``train/adversarial.py``) against the
JAX package's ``train_adversarial``.

The JAX side is one call of the JAX package's own ``train_adversarial``
(one epoch of one batch of 4 patches at the JAX test's widths, 2 x 128 x
128, with augmentation, a relation block and a mask: one compiled step),
from weights drawn with numpy on its tree (``jax.eval_shape``, no init
program). Its noise is rebuilt outside the step from the same key chain
(``fold_in(fold_in(PRNGKey(seed), 0), 0)`` -> ``split(3)`` -> the flips and
rotations, and for each adversarial update the prior sample and the
dropout masks of ``_apply_disc``) and handed to the port. Tolerances:

- the step's losses, rtol 1e-4; the batch-norm running statistics it
  ends with, atol 1e-6 (one-pass against two-pass statistics), the
  running means 2e-4 more (``BN_MEAN_SLACK``);
- Adam's first update is ``lr * g / (|g| + eps)``, about ``-lr * sign(g)``,
  so a gradient within rounding of 0 may step either way on either side:
  each parameter's change is compared only where every update that moves
  it has ``|g| > 1e-3`` of that update's largest gradient (the port's), and
  there within 1e-6 absolute (a flipped sign would be 2e-3 off).
"""
import copy
import os

import numpy as np
import pytest
import scipy.sparse
import torch

import jax
import jax.numpy as jnp

from dynamorph_tpu.models import vae as jvae
from dynamorph_tpu.train import adversarial as jax_adversarial
from dynamorph_tpu_torch.models import AAEModel
from dynamorph_tpu_torch.models.jax_import import (load_reference_checkpoint,
                                                   state_dict_from_jax)
from dynamorph_tpu_torch.train.adversarial import (STAGES, make_adversarial_step,
                                                   make_optimizers,
                                                   train_adversarial)
from dynamorph_tpu_torch.train.data import slice_mask
from dynamorph_tpu_torch.train.steps import augment_batch
from test_torch_vae_family import numpy_weights
from test_torch_train import _few_threads  # noqa: F401

KW = dict(num_hiddens=8, num_residual_hiddens=8, weight_matching=100.0,
          margin=1.0, w_a=1.0, w_t=0.5, w_n=-0.5)
B, SEED, LR = 4, 5, 1e-3
CLEAR = 1e-3        # |g| above this share of its tensor's largest
PARAM_ATOL = 1e-6
BN_ATOL = 1e-6
# a conv bias that feeds a batch norm has an exact gradient of 0, so its
# first Adam step is +-lr by the sign of rounding on either side; the
# discriminator update's forward then sees biases up to 2 lr apart, and
# its running means (momentum 0.1) up to 0.1 x 2 lr
BN_MEAN_SLACK = 0.1 * 2 * LR


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(
        np.asarray(a), -1, -3)))


def _jax_noise(seed, n, nh):
    """The step's draws, rebuilt from the JAX package's key chain: the
    augmentation's flips and rotations (``augment_batch``), and for each
    adversarial update the prior sample and the four dropout masks
    (``adversarial_loss``, ``_apply_disc``)."""
    step_key = jax.random.fold_in(jax.random.fold_in(
        jax.random.PRNGKey(seed), 0), 0)
    k_aug, k_d, k_g = jax.random.split(step_key, 3)
    k1, k2 = jax.random.split(k_aug)
    flips = torch.from_numpy(np.array(jax.random.randint(k1, (n,), 0, 3)))
    rots = torch.from_numpy(np.array(jax.random.randint(k2, (n,), 0, 4)))
    noise = {}
    for stage, k in (("dis", k_d), ("gen", k_g)):
        k_prior, k_d1, k_d2 = jax.random.split(k, 3)
        keep = []
        for kd in (k_d1, k_d2):
            ka, kd = jax.random.split(kd)
            keep.append(jax.random.bernoulli(ka, 0.75, (n, nh * 8)))
            kb, kd = jax.random.split(kd)
            keep.append(jax.random.bernoulli(kb, 0.75, (n, nh)))
        noise[stage] = {
            "z_prior": _nchw(jax.random.normal(k_prior, (n, 16, 16, nh))),
            "keep": [torch.from_numpy(np.array(m)) for m in keep]}
    return flips, rots, noise


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    jmodel = jvae.AAEModel(num_inputs=2, **KW)
    params, state = numpy_weights(jmodel, seed=3)
    r = np.random.RandomState(4)
    x = r.randn(B, 2, 128, 128).astype(np.float32)
    mask = np.where(r.rand(B, 2, 128, 128) > 0.3, 1.0, -1.0)
    rel = scipy.sparse.csr_matrix(r.randint(0, 3, (B, B)).astype(np.float64))
    out = str(tmp_path_factory.mktemp("jax_adv"))
    with pytest.MonkeyPatch.context() as mp:
        # its orbax checkpoint is never read here
        mp.setattr(jax_adversarial, "save_checkpoint", lambda *a, **k: None)
        jp, js, jhist = jax_adversarial.train_adversarial(
            jmodel, x, out, relation_mat=rel, mask=mask, n_epochs=1,
            lr_recon=LR, lr_dis=LR, lr_gen=LR, batch_size=B,
            transform=True, seed=SEED,
            params=jax.tree_util.tree_map(jnp.asarray, params),
            state=jax.tree_util.tree_map(jnp.asarray, state))
    after = state_dict_from_jax(jax.device_get(jp), jax.device_get(js),
                                "AAE")
    model = AAEModel(num_inputs=2, **KW)
    model.load_state_dict(state_dict_from_jax(params, state, "AAE"),
                          strict=True)
    flips, rots, noise = _jax_noise(SEED, B, KW["num_hiddens"])
    return dict(model=model, jax_after=after, jax_hist=jhist, x=x,
                mask=mask, rel=rel, flips=flips, rots=rots, noise=noise)


def _hooked_optimizers(model, record, *lrs):
    """``make_optimizers`` with ``record(stage, model)`` run after each
    update's backward, before its step (an optimizer step pre-hook)."""
    opts = make_optimizers(model, *lrs)
    for s, opt in opts.items():
        opt.register_step_pre_hook(lambda _o, _a, _k, s=s: record(s, model))
    return opts


def _port_step(run, transform):
    """The port's step on JAX's noise: with ``transform`` the flips and
    rotations go to the step's ``augment_batch``; without, the batch and
    mask arrive already turned and the step augments nothing. Returns
    (model after, losses, {stage: grads}, enc_d before the generator
    update)."""
    model = copy.deepcopy(run["model"])
    x = torch.from_numpy(run["x"])
    mask = torch.from_numpy(slice_mask(run["mask"], np.arange(B)))
    kw = {}
    if transform:
        kw = dict(flips=run["flips"], rots=run["rots"])
    else:
        x, mask = augment_batch(x, mask, flips=run["flips"],
                                rots=run["rots"])
    grads, before_gen = {}, {}

    def on_grads(stage, m):
        grads[stage] = {n: p.grad.detach().clone() if p.grad is not None
                        else torch.zeros_like(p)
                        for n, p in m.named_parameters()}
        if stage == "gen":
            before_gen.update({n: p.detach().clone()
                               for n, p in m.named_parameters()})

    step = make_adversarial_step(
        model, _hooked_optimizers(model, on_grads, LR, LR, LR),
        augment=transform)
    losses = step(x, np.asarray(run["rel"].todense()).astype(np.uint8), mask,
                  noise=run["noise"], **kw)
    return model, losses, grads, before_gen


def _largest(grads):
    return max(float(g.abs().max()) for g in grads.values())


@pytest.mark.parametrize("transform", [True, False],
                         ids=["augment-in-step", "pre-augmented"])
def test_adversarial_step_matches_jax(run, transform):
    model, losses, grads, _ = _port_step(run, transform)
    jh = run["jax_hist"][0]
    assert set(losses) | {"epoch"} == set(jh)
    for k, v in losses.items():
        np.testing.assert_allclose(float(v), jh[k], rtol=1e-4, atol=1e-7,
                                   err_msg=k)
    before = run["model"].state_dict()
    after = model.state_dict()
    compared = total = 0
    for n, _ in model.named_parameters():
        group = n.split(".")[0]
        if group == "enc_d":
            continue        # the JAX package's pass-through: next test
        clear = torch.ones_like(after[n], dtype=torch.bool)
        for stage in ("recon", "gen") if group == "enc" else ("recon",):
            clear &= grads[stage][n].abs() > CLEAR * _largest(grads[stage])
        d_port = (after[n] - before[n])[clear]
        d_jax = (run["jax_after"][n] - before[n])[clear]
        err = float((d_port - d_jax).abs().max()) if len(d_port) else 0.0
        assert err <= PARAM_ATOL, (n, err)
        compared += int(clear.sum())
        total += clear.numel()
    assert compared >= 0.8 * total, (compared, total)
    # the running statistics the step ends with: the discriminator
    # update's (the generator update's forward leaves them)
    n = 0
    for name, buf in model.named_buffers():
        if "running_" in name:
            atol = BN_ATOL + (BN_MEAN_SLACK if "mean" in name else 0.0)
            np.testing.assert_allclose(buf.numpy(),
                                       run["jax_after"][name].numpy(),
                                       rtol=0, atol=atol, err_msg=name)
            n += 1
    assert n >= 10


def test_jax_generator_update_adds_raw_gradient_to_enc_d(run):
    """The JAX package's fault: ``optax.masked`` passes the leaves outside
    its mask through as raw gradients, and ``apply_updates`` adds them, so
    its generator update adds the generator loss's gradient to the
    discriminator's weights (dynamorph_tpu/train/adversarial.py:55-57,
    :99-101). JAX's enc_d after the step minus the port's equals the
    port's own generator-loss gradient in enc_d, wherever the
    discriminator update's gradient clears rounding (at least half of
    enc_d's elements: dropout and dead units zero the rest); the port's
    generator update leaves enc_d where the discriminator update put it."""
    model, _, grads, before_gen = _port_step(run, True)
    after = model.state_dict()
    largest = 0.0
    compared = total = 0
    for n, p in model.named_parameters():
        if not n.startswith("enc_d."):
            continue
        assert torch.equal(after[n], before_gen[n]), n
        g_gen = grads["gen"][n]
        clear = grads["dis"][n].abs() > CLEAR * _largest(grads["dis"])
        diff = (run["jax_after"][n] - after[n])[clear] - g_gen[clear]
        if len(diff):
            tol = 1e-5 * float(g_gen.abs().max()) + PARAM_ATOL
            assert float(diff.abs().max()) <= tol, n
        compared += int(clear.sum())
        total += clear.numel()
        largest = max(largest, float(g_gen.abs().max()))
    assert compared >= 0.5 * total, (compared, total)
    assert largest > 1e-3       # the pass-through is not a rounding effect


def test_each_update_moves_only_its_group(run):
    """The recon update moves enc and dec, the discriminator's enc_d, the
    generator's enc: every other parameter keeps its value, though its
    gradient is nonzero (the generator loss reaches enc_d)."""
    model = copy.deepcopy(run["model"])
    x = torch.from_numpy(run["x"])
    seen = []

    def on_grads(stage, m):
        seen.append((stage, {n: p.detach().clone()
                             for n, p in m.named_parameters()},
                     {n for n, p in m.named_parameters()
                      if p.grad is not None and bool(p.grad.any())}))

    step = make_adversarial_step(model, _hooked_optimizers(model, on_grads),
                                 augment=False,
                                 generator=torch.Generator().manual_seed(0))
    step(x)
    seen.append(("end", {n: p.detach().clone()
                         for n, p in model.named_parameters()}, set()))
    moves = {"recon": ("enc", "dec"), "dis": ("enc_d",), "gen": ("enc",)}
    assert [s for s, _, _ in seen[:3]] == list(STAGES)
    assert any(n.startswith("enc_d.") for n in seen[2][2])
    for (stage, p0, _), (_, p1, _) in zip(seen, seen[1:]):
        for n in p0:
            if n.split(".")[0] not in moves[stage]:
                assert torch.equal(p0[n], p1[n]), (stage, n)


def test_train_adversarial_two_epochs_writes_loadable_checkpoints(
        run, tmp_path):
    model = copy.deepcopy(run["model"])
    r = np.random.RandomState(6)
    x = r.randn(8, 2, 128, 128).astype(np.float32)
    _, hist = train_adversarial(model, x, str(tmp_path), n_epochs=2,
                                batch_size=B, transform=True, seed=0,
                                shuffle_data=True, device="cpu")
    assert [h["epoch"] for h in hist] == [0, 1]
    assert all(set(h) == set(run["jax_hist"][0]) for h in hist)
    assert all(np.isfinite(v) for h in hist for v in h.values())
    for e in (0, 1):
        fresh = AAEModel(num_inputs=2, **KW)
        fresh.load_state_dict(load_reference_checkpoint(
            os.path.join(tmp_path, f"model_epoch{e}", "model.pt")),
            strict=True)
    last = fresh.state_dict()
    assert all(torch.equal(last[k], v.cpu())
               for k, v in model.state_dict().items())
    with open(tmp_path / "metrics.jsonl") as f:
        assert len(f.readlines()) == 2
