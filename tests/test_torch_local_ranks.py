"""``run_training.run`` over several devices of one process: one local
rank a device (``core.mesh.run_local_ranks``), against the two-rank
``run_training --multihost`` run of ``tests/test_torch_multirank.py``
(its ``_training_dir`` and ``_spawn_ranks``), on the CPU over gloo.

- The VQ-VAE branch (trajectory-sharded ring loss, cross-rank batch norm)
  and the ResNet branch (the data-parallel triplet step): the same
  history and ``model.pt`` bit for bit, and ``run`` returns rank 0's
  history and the model rank 0 wrote. The local ranks seed torch and
  ``np.random`` from one draw of the caller's ``np.random``; the
  ``--multihost`` ranks here are seeded with the same draw.
- A failing rank: ``run`` raises, naming the rank, and a rank that waits
  in a collective for a failed one is stopped at once, not at the
  collectives' timeout.

Every rank of a branch's two runs takes the same intra-op thread count
(``THREADS``): the CPU's reductions, and so the bits, follow it. The
VQ-VAE branch runs at ``_spawn_ranks``' 2 threads; the ResNet branch at
1, since at 2 its runs are not bit-reproducible on the CPU (1 of 6
runs differed by 3.5e-06 relative in an epoch's loss; none of 8 at 1).
"""
import json
import os
import sys
import time

import numpy as np
import pytest
import torch

from dynamorph_tpu_torch.cli import run_training
from dynamorph_tpu_torch.config import load_config
from dynamorph_tpu_torch.core import mesh
from dynamorph_tpu_torch.io.pickles import save_pickle
from rank_faults import fail_on_rank_one
from test_torch_multirank import (REPO, _free_port, _spawn_ranks,
                                  _training_dir)
from test_torch_train import _few_threads  # noqa: F401

CALLER_SEED = 11
# torch's intra-op threads in every rank of a branch's runs
THREADS = {"VQ_VAE_z16": 2, "ResNet18": 1}

# one --multihost rank, its RNG streams seeded as a local rank seeds them
MULTIHOST_RANK = (
    "import sys, json; sys.path.insert(0, {repo!r}); import numpy as np, "
    "torch; torch.set_num_threads({threads}); np.random.seed({seed}); "
    "torch.manual_seed({seed}); "
    "from dynamorph_tpu_torch.cli import run_training; "
    "_, h = run_training.main(sys.argv[1:]); "
    "print('HISTORY:' + json.dumps(h))")


def _resnet_dir(root):
    """16 patches of 16 x 16 in 4 classes, ResNet18 at batch 8 (4 anchors
    of 2 samples a step: 4 rows a rank), 2 epochs."""
    raw = os.path.join(root, "raw")
    os.makedirs(raw)
    r = np.random.RandomState(10)
    save_pickle(r.rand(16, 2, 1, 16, 16) * 65535.0,
                os.path.join(raw, "im_static_patches.pkl"))
    save_pickle(np.arange(16) % 4,
                os.path.join(raw, "im_static_patches_labels.pkl"))
    save_pickle({}, os.path.join(raw, "im_static_patches_relations.pkl"))
    cfg = os.path.join(root, "cfg.yml")
    with open(cfg, "w") as f:
        f.write("training:\n"
                f"  raw_dirs: ['{raw}']\n  supp_dirs: ['{root}/supp']\n"
                f"  weights_dirs: ['{root}/weights']\n"
                "  network: 'ResNet18'\n  n_epochs: 2\n"
                "  learn_rate: 0.0001\n  batch_size: 8\n  n_pos_samples: 2\n"
                "  val_split_ratio: 0.25\n  margin: 1\n  model_name: 'm'\n")
    return cfg


def _multihost(cfg, seed, threads):
    port = _free_port()
    code = MULTIHOST_RANK.format(repo=REPO, seed=seed, threads=threads)
    res = _spawn_ranks(lambda r: [
        sys.executable, "-c", code, "-c", cfg, "--device", "cpu",
        "--multihost", "--coordinator", f"127.0.0.1:{port}",
        "--num-processes", "2", "--process-id", str(r)])
    hists = []
    for rc, out, err in res:
        assert rc == 0, err[-3000:]
        line = [ln for ln in out.splitlines() if ln.startswith("HISTORY:")]
        hists.append(json.loads(line[0][len("HISTORY:"):]))
    assert hists[0] == hists[1]
    return hists[0]


@pytest.mark.parametrize("branch", ["VQ_VAE_z16", "ResNet18"])
def test_local_ranks_match_multihost(tmp_path, monkeypatch, branch):
    make = _training_dir if branch == "VQ_VAE_z16" else _resnet_dir
    threads = THREADS[branch]
    monkeypatch.setenv("OMP_NUM_THREADS", str(threads))
    seed = int(np.random.RandomState(CALLER_SEED).randint(0, 2 ** 31 - 1))
    want = _multihost(make(str(tmp_path / "multihost")), seed, threads)

    cfg = load_config(make(str(tmp_path / "local")))
    np.random.seed(CALLER_SEED)
    model, got = run_training.run(cfg, device="cpu", devices=["cpu", "cpu"])
    assert got == want
    assert len(got) == 2
    name = "vq" if branch == "VQ_VAE_z16" else "m"
    one = torch.load(tmp_path / "multihost" / "weights" / name / "model.pt",
                     weights_only=True)
    two = torch.load(tmp_path / "local" / "weights" / name / "model.pt",
                     weights_only=True)
    assert one.keys() == two.keys()
    for k in one:
        assert torch.equal(one[k], two[k]), k
    sd = model.state_dict()
    for k, v in two.items():
        assert torch.equal(sd[k], v), k


def test_a_failing_rank_stops_the_run(tmp_path, monkeypatch):
    """A batch that does not split over the ranks fails every rank, and
    ``run`` names one; a rank that fails while the other waits in a
    barrier is named and the waiting rank is stopped within seconds, not
    at the collectives' timeout (``mesh.DEFAULT_TIMEOUT_S``, 600 s)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    cfg = load_config(_training_dir(str(tmp_path / "odd")))
    cfg.training.batch_size = 7
    with pytest.raises(RuntimeError, match=r"(?s)--- rank [01] on cpu, .*"
                                           r"batch_size 7 does not split"):
        run_training.run(cfg, device="cpu", devices=["cpu", "cpu"])
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"(?s)--- rank 1 on cpu, .*"
                                           r"planted failure on rank one"):
        mesh.run_local_ranks(fail_on_rank_one, (), ["cpu", "cpu"])
    assert time.monotonic() - t0 < 60
