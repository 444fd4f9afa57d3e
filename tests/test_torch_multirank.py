"""The port's data parallelism across processes: two ranks over gloo on the
CPU, each an OS process (``core.mesh.init_multihost``), against one
process and against the JAX package.

- the z16 data-parallel step (trajectory-sharded ring loss, cross-rank
  batch norm, global augmentation draws, averaged gradients) and the
  ResNet18 all-triplet step on the gathered batch, three steps each:
  against the one-process port step on the whole batch from the same
  weights (losses within 1e-5, the step bound of tests/test_multihost.py;
  the averaged gradients at ``GRAD_RTOL``; the ranks bit for bit alike),
  and
  the first
  z16 step against the JAX package's step on ``make_mesh(2)`` at
  tests/test_torch_train.py's stated tolerances (the one-process triplet
  step is held against the JAX package in tests/test_torch_resnet.py);
- ``run_training --multihost`` against ``run_training`` in one process;
- ``run_pipeline --multihost`` on a two-well plate against one process,
  with the PCA fitted once on rank 0, and a failure planted on rank 1
  that makes both ranks exit non-zero.

Every rank runs under a subprocess timeout, so a fault fails the test
instead of hanging it. lr is 1e-6 throughout: Adam turns the rounding
noise on the zero-gradient conv biases in front of batch norm into steps
of about lr (tests/test_torch_train.py), which one process and two ranks
round differently.
"""
import ast
import json
import os
import shutil
import socket
import subprocess
import sys

import numpy as np
import torch

from dynamorph_tpu_torch.models import VQVAEz16
from dynamorph_tpu_torch.models.resnet_simclr import EncodeProject
from dynamorph_tpu_torch.train import sharded_loss as SL
from dynamorph_tpu_torch.train.steps import (make_train_step,
                                             make_triplet_steps)
from test_torch_train import _few_threads  # noqa: F401
from test_torch_train import _pre_bn_biases

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")
TIMEOUT_S = 300
B = 8                           # the global batch: 4 rows a rank
Z16_KW = dict(num_hiddens=16, num_residual_hiddens=8, num_embeddings=32,
              weight_matching=100.0, margin=1.0, w_a=1.0, w_t=0.5,
              w_n=-0.5)
LR = 1e-6

# one rank: join the group, run a function of this module, save its result
WORKER = r"""
import sys
sys.path[:0] = [{repo!r}, {tests!r}]
import torch
torch.set_num_threads(2)
from dynamorph_tpu_torch.core import mesh
pid, port, root = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
mesh.init_multihost(f"127.0.0.1:{{port}}", 2, pid, backend="gloo",
                    timeout_s=120)
import test_torch_multirank as T
torch.save(T.rank_steps(mesh.ProcessGroupComm(), root),
           f"{{root}}/rank{{pid}}.pt")
mesh.shutdown_multihost()
"""

# one rank of run_pipeline --multihost, with a failure planted on rank 1
PIPELINE_WORKER = r"""
import sys
sys.path[:0] = [{repo!r}]
pid, port, cfg, fail = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                        sys.argv[4] == "fail")
if fail and pid == 1:
    from dynamorph_tpu_torch.pipeline import orchestrator

    def _boom(*a, **k):
        raise RuntimeError("injected stage failure")
    orchestrator.instance_segmentation = _boom
from dynamorph_tpu_torch.cli import run_pipeline
run_pipeline.main(["-c", cfg, "--device", "cpu", "--stages", *{stages!r},
                   "--multihost", "--coordinator", f"127.0.0.1:{{port}}",
                   "--num-processes", "2", "--process-id", str(pid)])
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn_ranks(argv_of_rank, timeout=TIMEOUT_S):
    """Two rank processes; (returncode, stdout, stderr) of each. A rank
    that outlives the timeout kills both and fails the test."""
    env = dict(os.environ, OMP_NUM_THREADS="2")
    procs = [subprocess.Popen(argv_of_rank(r), env=env, cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    out = []
    for p in procs:
        try:
            o, e = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise AssertionError("a rank hung past the timeout")
        out.append((p.returncode, o, e))
    return out


# ------------------------------------------------------------- the steps


def _traj_relations(n, length=4):
    """Trajectories of ``length`` consecutive samples (2: adjacent, 1: the
    same trajectory, 0: negatives)."""
    rel = np.zeros((n, n), np.int64)
    for s in range(0, n, length):
        for i in range(s, s + length):
            for j in range(s, s + length):
                rel[i, j] = 2 if abs(i - j) <= 1 else 1
    return rel


def step_inputs():
    """Three seeded batches of 8 (two trajectories of 4 each, so the
    blocked loss is the dense one), masks, the packed order and the
    ResNet18's seeded weights (the z16's come from the JAX side)."""
    r = np.random.RandomState(5)
    rel = _traj_relations(B)
    tid = SL.trajectory_ids_from_relations(rel, B)
    torch.manual_seed(0)
    triplet = EncodeProject(arch="ResNet18", num_inputs=2, margin=0.5)
    return dict(
        x=[r.randn(B, 2, 32, 32).astype(np.float32) for _ in range(3)],
        mask=[(r.rand(B, 2, 32, 32) > 0.3).astype(np.uint8)
              for _ in range(3)],
        rel=rel, packed=SL.pack_trajectories(np.arange(B), tid, 2),
        labels=np.repeat(np.arange(4), 2),
        triplet=triplet.state_dict())


def rank_steps(comm, root, replay=None):
    """Three z16 steps (the first without augmentation) and three triplet
    steps; ``comm`` None is one process on the whole batch with the dense
    loss. Returns each step's losses and (averaged) gradients, the state
    before each step and the state after. With ``replay`` (such a result)
    each step starts from the state the replayed run had before it, so
    the two runs' steps see the same weights (Adam would otherwise spread
    their rounding noise over the weights, above)."""
    inp = torch.load(os.path.join(root, "inputs.pt"), weights_only=False)
    world, rank = (1, 0) if comm is None else (comm.world, comm.rank)
    b = B // world
    rows = inp["packed"][rank * b:(rank + 1) * b]
    rel = inp["rel"]
    model = VQVAEz16(**Z16_KW)
    model.load_state_dict(inp["z16"])
    if comm is None:
        block = rel[inp["packed"]][:, inp["packed"]]
    else:
        model.tm_loss_fn = SL.make_traj_sharded_tm_loss(comm)
        block = SL.blockdiag_relations(rel, inp["packed"],
                                       world)[rank * b:(rank + 1) * b]
    gen = torch.Generator().manual_seed(0)
    opt = torch.optim.Adam(model.parameters(), lr=LR)
    out = {"z16": [], "triplet": [], "z16_before": [],
           "triplet_before": []}

    def start(net, i, name):
        if replay is not None:
            net.load_state_dict(replay[f"{name}_before"][i])
        out[f"{name}_before"].append(
            {k: v.clone() for k, v in net.state_dict().items()})

    for i, augment in enumerate((False, True, True)):
        step = make_train_step(model, opt, augment=augment, generator=gen,
                               comm=comm)
        start(model, i, "z16")
        losses = step(torch.from_numpy(inp["x"][i][rows]), block,
                      inp["mask"][i][rows])
        out["z16"].append((
            {k: float(v) for k, v in losses.items()},
            {k: p.grad.clone() for k, p in model.named_parameters()}))
    out["z16_state"] = model.state_dict()
    net = EncodeProject(arch="ResNet18", num_inputs=2, margin=0.5)
    net.load_state_dict(inp["triplet"])
    step, _ = make_triplet_steps(
        net, torch.optim.Adam(net.parameters(), lr=LR), comm=comm)
    rows = slice(rank * b, (rank + 1) * b)
    for i in range(3):
        start(net, i, "triplet")
        losses = step(torch.from_numpy(inp["x"][i][rows]),
                      torch.from_numpy(inp["labels"][rows]))
        out["triplet"].append((
            {k: float(v) for k, v in losses.items()},
            {k: p.grad.clone() for k, p in net.named_parameters()
             if p.grad is not None}))
    out["triplet_state"] = net.state_dict()
    return out


# Gradients, two ranks against one process from the same weights, per
# tensor as the L2 norm of the difference over the tensor's: within 1e-4,
# since the worst tensor's fp32 gradient sits up to 2e-5 from float64 on
# either side (measured on this test's first steps, in float64 replays:
# z16 one process 2.0e-5, two ranks 1.5e-5, both at the last residual
# batch norm's offset, median 6e-7; ResNet18 1.75e-5 and 1.70e-5). The
# conv biases in front of a batch norm have an exact gradient of 0: both
# sides stay below 1e-5 of the model's largest (tests/test_torch_train.py).
GRAD_RTOL = 1e-4
PRE_BN = _pre_bn_biases(VQVAEz16(**Z16_KW))


def _close(got, want, what):
    """Losses within 1e-5, gradients within ``GRAD_RTOL`` (above)."""
    for k in want[0]:
        np.testing.assert_allclose(got[0][k], want[0][k], rtol=1e-5,
                                   atol=1e-7, err_msg=f"{what} {k}")
    assert set(got[1]) == set(want[1])
    scale = max(float(g.abs().max()) for g in want[1].values())
    for k, g in want[1].items():
        if k in PRE_BN:
            assert max(float(got[1][k].abs().max()),
                       float(g.abs().max())) <= 1e-5 * scale, (what, k)
            continue
        err = float((got[1][k] - g).norm() / g.norm())
        assert err <= GRAD_RTOL, (what, k, err)


def _jax_first_step(inp):
    """The JAX package's z16 train step on ``make_mesh(2)`` with its
    trajectory-sharded loss, on the first batch (packed, no
    augmentation): losses and gradients under the port's names."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from dynamorph_tpu.core.mesh import make_mesh
    from dynamorph_tpu.models import VQVAEz16 as JaxZ16
    from dynamorph_tpu.train import sharded_loss as JSL
    from dynamorph_tpu_torch.models.jax_import import state_dict_from_jax
    from test_torch_train import _numpy_weights

    jmodel = dataclasses.replace(
        JaxZ16(vq_impl="xla", **Z16_KW),
        tm_loss_fn=JSL.make_traj_sharded_tm_loss(make_mesh(2)))
    params, state = _numpy_weights(jmodel, seed=3)
    packed = inp["packed"]
    blocks = SL.blockdiag_relations(inp["rel"], packed, 2)

    def loss_fn(p, x, rel, mask):
        _, losses, _ = jmodel.apply(p, state, x, train=True,
                                    time_matching_mat=rel, batch_mask=mask)
        return losses["total_loss"], losses

    (_, losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, jnp.asarray(inp["x"][0][packed]),
        jnp.asarray(blocks, jnp.float32),
        jnp.asarray(inp["mask"][0][packed], jnp.float32))
    losses, grads = jax.device_get((losses, grads))
    return (state_dict_from_jax(params, state, "VQ_VAE_z16"),
            {k: float(v) for k, v in losses.items()},
            state_dict_from_jax(grads, state, "VQ_VAE_z16"))


def test_two_rank_steps_match_one_process_and_jax(tmp_path):
    root = str(tmp_path)
    inp = step_inputs()
    jax_weights, jax_losses, jax_grads = _jax_first_step(inp)
    inp["z16"] = jax_weights
    torch.save(inp, os.path.join(root, "inputs.pt"))
    port = _free_port()
    worker = WORKER.format(repo=REPO, tests=TESTS)
    res = _spawn_ranks(lambda r: [sys.executable, "-c", worker, str(r),
                                  str(port), root])
    for rc, _, err in res:
        assert rc == 0, err[-3000:]
    ranks = [torch.load(os.path.join(root, f"rank{r}.pt"),
                        weights_only=False) for r in range(2)]
    one = rank_steps(None, root, replay=ranks[0])

    for net in ("z16", "triplet"):
        # the ranks alike, bit for bit: losses, gradients, the state after
        for (l0, g0), (l1, g1) in zip(ranks[0][net], ranks[1][net]):
            assert l0 == l1
            for k in g0:
                assert torch.equal(g0[k], g1[k]), (net, k)
        for k, v in ranks[0][f"{net}_state"].items():
            assert torch.equal(v, ranks[1][f"{net}_state"][k]), (net, k)
        for i, (got, want) in enumerate(zip(ranks[0][net], one[net])):
            _close(got, want, f"{net} step {i}")
        # the global batch's running statistics, as one process updates
        # them from the same weights
        for k, v in one[f"{net}_state"].items():
            if "running_" in k:
                np.testing.assert_allclose(
                    ranks[0][f"{net}_state"][k].numpy(), v.numpy(),
                    rtol=1e-5, atol=1e-6, err_msg=f"{net} {k}")
    assert ranks[0]["z16"][0][0]["time_matching_loss"] > 0
    assert ranks[0]["triplet"][0][0]["positive_triplet"] > 0

    # the first z16 step against the JAX package on a two-device mesh
    losses, grads = ranks[0]["z16"][0]
    for k, v in jax_losses.items():
        np.testing.assert_allclose(losses[k], v, rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    scale = max(float(np.abs(g.numpy()).max()) for g in jax_grads.values())
    for k, g in grads.items():
        g_j = jax_grads[k].numpy()
        if k in PRE_BN:
            assert max(float(g.abs().max()),
                       float(np.abs(g_j).max())) <= 1e-5 * scale, k
            continue
        np.testing.assert_allclose(
            g.numpy(), g_j, rtol=1e-3,
            atol=1e-5 * max(np.abs(g_j).max(), 1e-3 * scale), err_msg=k)


# -------------------------------------------------- run_training --multihost


def _training_dir(root):
    """40 patches in 10 trajectories of 4 and the config: reordered, the
    trajectories sit at multiples of 4, and the val split (8 at 12, seed
    0's draw) leaves 4 train batches and 1 val batch of whole
    trajectories, so no batch is partial and packing keeps each batch's
    order."""
    from dynamorph_tpu_torch.io.pickles import save_pickle

    raw = os.path.join(root, "raw")
    os.makedirs(raw)
    r = np.random.RandomState(0)
    save_pickle(r.rand(40, 2, 1, 32, 32) * 65535.0,
                os.path.join(raw, "im_static_patches.pkl"))
    save_pickle(np.arange(40), os.path.join(raw,
                                            "im_static_patches_labels.pkl"))
    rel = {(a, b): 2 if abs(a - b) == 1 else 1
           for t in range(10) for a in range(4 * t, 4 * t + 4)
           for b in range(4 * t, 4 * t + 4) if a != b}
    save_pickle(rel, os.path.join(raw, "im_static_patches_relations.pkl"))
    # the same start weights for every run (the port's init is unseeded)
    torch.manual_seed(2)
    start = os.path.join(root, "start.pt")
    torch.save(VQVAEz16(num_hiddens=8, num_residual_hiddens=8,
                        num_embeddings=16).state_dict(), start)
    cfg = os.path.join(root, "cfg.yml")
    with open(cfg, "w") as f:
        f.write("training:\n"
                f"  raw_dirs: ['{raw}']\n  supp_dirs: ['{root}/supp']\n"
                f"  weights_dirs: ['{root}/weights']\n"
                "  network: 'VQ_VAE_z16'\n  num_hiddens: 8\n"
                "  num_residual_hiddens: 8\n  num_embeddings: 16\n"
                "  weight_matching: 100\n  margin: 1\n  w_a: 1\n  w_t: 0.5\n"
                "  w_n: -0.5\n  n_epochs: 2\n  learn_rate: 0.000001\n"
                "  batch_size: 8\n  val_split_ratio: 0.2125\n"
                f"  model_name: 'vq'\n  start_model_path: '{start}'\n")
    return cfg


def test_run_training_multihost_matches_one_process(tmp_path):
    from dynamorph_tpu_torch.cli import run_training
    from dynamorph_tpu_torch.pipeline.patch_vae import _load_model_weights

    one_cfg = _training_dir(str(tmp_path / "one"))
    _, hist_one = run_training.main(["-c", one_cfg, "--device", "cpu"])
    cfg = _training_dir(str(tmp_path / "two"))
    port = _free_port()
    code = ("import sys, json; sys.path.insert(0, {!r}); "
            "from dynamorph_tpu_torch.cli import run_training; "
            "_, h = run_training.main(sys.argv[1:]); "
            "print('HISTORY:' + json.dumps(h))").format(REPO)
    res = _spawn_ranks(lambda r: [
        sys.executable, "-c", code, "-c", cfg, "--device", "cpu",
        "--multihost", "--coordinator", f"127.0.0.1:{port}",
        "--num-processes", "2", "--process-id", str(r)])
    hists = []
    for rc, out, err in res:
        assert rc == 0, err[-3000:]
        line = [ln for ln in out.splitlines() if ln.startswith("HISTORY:")]
        hists.append(json.loads(line[0][len("HISTORY:"):]))
    assert hists[0] == hists[1]                       # bit for bit
    assert len(hists[0]) == len(hist_one) == 2
    # train losses within 1e-5 (measured 1.7e-7); val losses within 1e-4:
    # the val steps normalise with the running statistics, which follow
    # the steps of about lr that Adam takes on the zero-gradient biases
    # from rounding noise (measured 2.4e-5 on the commitment loss, the
    # difference of two close quantities; the others 1.2e-7)
    for ep, ep1 in zip(hists[0], hist_one):
        for split, rtol in (("train", 1e-5), ("val", 1e-4)):
            assert set(ep[split]) == set(ep1[split])
            for k, v in ep1[split].items():
                np.testing.assert_allclose(ep[split][k], v, rtol=rtol,
                                           atol=1e-7, err_msg=(split, k))
    assert hists[0][0]["train"]["time_matching_loss"] > 0
    out_dir = tmp_path / "two" / "weights" / "vq"
    # rank 0 alone wrote the metrics (2 epochs x train and val) and the
    # one model.pt, which loads strict for run_vae -m process
    with open(out_dir / "metrics.jsonl") as f:
        assert len(f.read().splitlines()) == 4

    def names(d):       # TensorBoard's event file is named by its time
        return sorted("events" if n.startswith("events.") else n
                      for n in os.listdir(d))

    assert names(out_dir) == names(tmp_path / "one" / "weights" / "vq")
    two = _load_model_weights(VQVAEz16(num_hiddens=8, num_residual_hiddens=8,
                                       num_embeddings=16),
                              str(out_dir / "model.pt")).state_dict()
    one = torch.load(tmp_path / "one" / "weights" / "vq" / "model.pt",
                     weights_only=True)
    for k, v in one.items():
        # two epochs of 4 Adam steps at lr 1e-6 apart, at most
        np.testing.assert_allclose(two[k].numpy(), v.numpy(), rtol=1e-5,
                                   atol=8 * LR, err_msg=k)


# -------------------------------------------------- run_pipeline --multihost

STAGES = ["instance_segmentation", "extract_patches", "build_trajectories",
          "assemble", "process", "trajectory_matching", "pca"]


def _plate(root):
    """Two wells of one site each (tests/test_torch_patch_track.py's two
    synthetic sites), tiny VQ-VAE weights and the config."""
    from test_torch_patch_track import (EDGE_SITE, INPUT, SITE, WINDOW,
                                        _edge_site, _site)

    raw, supp = os.path.join(root, "raw"), os.path.join(root, "supp")
    os.makedirs(raw)
    for site, (stack, probs) in ((SITE, _site()), (EDGE_SITE, _edge_site())):
        np.save(os.path.join(raw, f"{site}.npy"), stack)
        np.save(os.path.join(raw, f"{site}_NNProbabilities.npy"), probs)
    weights = os.path.join(root, "vq")
    os.makedirs(weights)
    torch.manual_seed(1)
    torch.save(VQVAEz16(num_hiddens=8, num_residual_hiddens=8,
                        num_embeddings=16).state_dict(),
               os.path.join(weights, "model.pt"))
    wells = sorted(s.split("-")[0] for s in (SITE, EDGE_SITE))
    cfg = os.path.join(root, "pipe.yml")
    with open(cfg, "w") as f:
        f.write(f"patch:\n  raw_dirs: ['{raw}']\n  supp_dirs: ['{supp}']\n"
                f"  window_size: {WINDOW}\n"
                f"latent_encoding:\n  input_size: {INPUT}\n"
                f"  weights: '{weights}'\n  network: 'VQ_VAE_z16'\n"
                "  num_hiddens: 8\n  num_residual_hiddens: 8\n"
                "  num_embeddings: 16\n  save_output: false\n"
                f"dim_reduction:\n  input_dirs: ['{raw}/vq']\n"
                f"  output_dirs: ['{raw}/vq']\n"
                f"  weights_dir: '{root}/pca'\n  fit_model: true\n"
                f"  file_name_prefixes: {wells}\n  conditions: {wells}\n")
    return cfg


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            if not n.endswith(".yml"):
                with open(p, "rb") as f:
                    out[os.path.relpath(p, root)] = f.read()
    return out


def _executed(out):
    line = [ln for ln in out.splitlines() if ": executed stages " in ln]
    return ast.literal_eval(line[0].split(": executed stages ")[1])


def test_run_pipeline_multihost_matches_one_process_and_fails_together(
        tmp_path):
    from dynamorph_tpu_torch.cli import run_pipeline

    one = str(tmp_path / "one")
    cfg_one = _plate(one)
    executed_one = run_pipeline.main(["-c", cfg_one, "--device", "cpu",
                                      "--stages", *STAGES])
    assert list(executed_one.values())[0] == STAGES

    def ranks(root, mode):
        cfg = _plate(root)
        port = _free_port()
        worker = PIPELINE_WORKER.format(repo=REPO, stages=STAGES)
        return _spawn_ranks(lambda r: [sys.executable, "-c", worker, str(r),
                                       str(port), cfg, mode])

    two = str(tmp_path / "two")
    res = ranks(two, "ok")
    for rc, _, err in res:
        assert rc == 0, err[-3000:]
    # each rank ran every stage of its own well; the fit ran on rank 0 only
    assert _executed(res[0][1]) == STAGES
    assert _executed(res[1][1]) == STAGES[:-1]
    assert "owns wells ['B2']" in res[0][2]
    assert "owns wells ['C3']" in res[1][2]
    files_one, files_two = _files(one), _files(two)
    assert sorted(files_two) == sorted(files_one)
    assert "pca/pca_model.pkl" in files_two
    for k, v in files_one.items():
        # the file lists name their directories: "one" and "two" are as
        # long, so the pickles stay byte-comparable
        assert files_two[k] == v.replace(b"/one/", b"/two/"), k

    failed = str(tmp_path / "failed")
    res = ranks(failed, "fail")
    assert res[1][0] != 0 and "injected stage failure" in res[1][2]
    assert res[0][0] != 0 and "failed on rank(s) [1]" in res[0][2]
    assert not os.path.exists(os.path.join(failed, "pca", "pca_model.pkl"))
    shutil.rmtree(failed)
