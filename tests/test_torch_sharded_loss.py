"""The port's data-parallel pieces inside one process, against the JAX
package: ``train/sharded_loss.py``, ``core/mesh.py``'s host helpers, the
ring loss and its gradient, the cross-rank batch norm, the global-batch
augmentation draws, ``fit_pca_distributed`` and the fanned-out
``encode_patches``; and ``io/prefetch.AsyncWriter`` shared by threads.

Several ranks run inside one process, a thread each, through
``ThreadComm`` (an in-memory communicator with ``core.mesh``'s
interface), so the collectives, the ring's autograd and the batch norm's
all-reduces run the code that ``ProcessGroupComm`` drives across processes
(``tests/test_torch_multirank.py`` runs that over gloo).

Gradients: each rank's gradient is that of the sum of every rank's copy of
the (replicated) loss, ``world`` times the global batch's
(``core/mesh.py``'s convention; the step averages over the ranks), so a
rank's gradient divided by ``world`` is compared with the JAX package's
gradient of the global loss. Tolerances: the ring loss against the JAX
package's ``make_traj_sharded_tm_loss`` at JAX's own bounds
(tests/test_sharded_tm_loss.py:57-73: loss rtol 1e-6 atol 1e-7, gradients
rtol 1e-5 atol 1e-6); the distributed PCA and encode at
tests/test_multidevice.py:27-38's (atol 1e-5, rtol 1e-5); ranks against
one process at 1e-5 (reduction order).
"""
import threading

import numpy as np
import pytest
import torch
from scipy.sparse import csr_matrix
from torch import nn

import jax
import jax.numpy as jnp

from dynamorph_tpu.core import mesh as jmesh
from dynamorph_tpu.models import VQVAEz16 as JaxZ16
from dynamorph_tpu.pipeline.patch_vae import encode_patches as jax_encode
from dynamorph_tpu.reduce.pca import fit_pca_distributed as jax_fit_pca_dist
from dynamorph_tpu.train import sharded_loss as JSL
from dynamorph_tpu_torch.core import mesh
from dynamorph_tpu_torch.io.prefetch import AsyncWriter
from dynamorph_tpu_torch.models import VQVAEz16, common
from dynamorph_tpu_torch.models.jax_import import state_dict_from_jax
from dynamorph_tpu_torch.nn.batchnorm import (BatchNorm2d,
                                              cross_rank_batch_norm)
from dynamorph_tpu_torch.ops import batch_norm as bn_ops
from dynamorph_tpu_torch.pipeline.patch_vae import encode_patches
from dynamorph_tpu_torch.reduce.pca import fit_pca_distributed
from dynamorph_tpu_torch.train import sharded_loss as SL
from dynamorph_tpu_torch.train.steps import augment_batch
from test_torch_train import _few_threads  # noqa: F401

W = dict(w_a=1.1, w_t=0.1, w_n=-0.5, margin=0.5)
CPU = torch.device("cpu")


class _Board:
    def __init__(self, n):
        self.n = n
        self.barrier = threading.Barrier(n, timeout=120)
        self.slots = [None] * n


class ThreadComm:
    """``core.mesh``'s communicator interface for ranks that are threads
    of one process: every collective posts each rank's tensor on a shared
    board between two barriers. Sums run in rank order, the same on every
    rank."""

    def __init__(self, board, rank):
        self.board, self.rank, self.world = board, rank, board.n
        self.sent_bytes = 0

    def _exchange(self, t):
        b = self.board
        b.slots[self.rank] = t.detach().clone()
        b.barrier.wait()
        out = list(b.slots)
        b.barrier.wait()
        return out

    def all_reduce(self, t):
        parts = self._exchange(t)
        total = parts[0].clone()
        for p in parts[1:]:
            total += p
        return total

    def all_gather(self, t):
        return [p.clone() for p in self._exchange(t)]

    def broadcast(self, t, src=0):
        t.copy_(self._exchange(t)[src])

    def shift(self, t, steps=1):
        self.sent_bytes += t.numel() * t.element_size()
        return self._exchange(t)[(self.rank - steps) % self.world].clone()


def run_ranks(n, fn):
    """``fn(comm)`` on ``n`` threads, one rank each; the results in rank
    order. A rank that raises breaks the others' barriers."""
    board = _Board(n)
    results, errors = [None] * n, []

    def target(r):
        try:
            results[r] = fn(ThreadComm(board, r))
        except BaseException as e:      # noqa: BLE001 (re-raised below)
            errors.append(e)
            board.barrier.abort()

    threads = [threading.Thread(target=target, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results


def _traj_relations(lengths):
    """Dense relation matrix and trajectory ids of consecutive
    trajectories (tests/test_sharded_tm_loss.py:21-37)."""
    n = sum(lengths)
    rel = np.zeros((n, n), np.int64)
    tid = np.zeros(n, np.int64)
    start = 0
    for t, ln in enumerate(lengths):
        for i in range(start, start + ln):
            tid[i] = t
            for j in range(start, start + ln):
                if i != j:
                    rel[i, j] = 2 if abs(i - j) == 1 else 1
        rel[np.arange(start, start + ln), np.arange(start, start + ln)] = 2
        start += ln
    return rel, tid


LENGTHS = [4, 2, 2, 4, 1, 3, 4, 4, 2, 2, 4]     # 32 samples


def test_cross_sq_dist_mean_matches_jax(rng):
    a = rng.randn(6, 40).astype(np.float32)
    b = rng.randn(5, 40).astype(np.float32)
    got = SL.cross_sq_dist_mean(torch.from_numpy(a), torch.from_numpy(b))
    want = JSL.cross_sq_dist_mean(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("sparse", [True, False])
def test_trajectory_ids_match_jax(sparse):
    rel, _ = _traj_relations([3, 5, 1, 2, 4])
    perm = np.random.RandomState(3).permutation(len(rel))
    rel = rel[perm][:, perm]           # components not in index order
    mat = csr_matrix(rel) if sparse else rel
    got = SL.trajectory_ids_from_relations(mat, len(rel))
    want = JSL.trajectory_ids_from_relations(csr_matrix(rel), len(rel))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        SL.trajectory_ids_from_relations(None, 7),
        JSL.trajectory_ids_from_relations(None, 7))


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_pack_and_blockdiag_match_jax(n_shards):
    rel, tid = _traj_relations(LENGTHS)
    bids = np.random.RandomState(n_shards).permutation(len(rel))
    packed = SL.pack_trajectories(bids, tid, n_shards)
    np.testing.assert_array_equal(
        packed, JSL.pack_trajectories(bids, tid, n_shards))
    np.testing.assert_array_equal(
        SL.blockdiag_relations(csr_matrix(rel), packed, n_shards),
        JSL.blockdiag_relations(csr_matrix(rel), packed, n_shards))
    with pytest.raises(ValueError, match="equal rank shards"):
        SL.pack_trajectories(bids[:-1], tid, n_shards)


@pytest.mark.parametrize("n_items,world", [(2, 2), (5, 2), (7, 3),
                                           (3, 4), (24, 4)])
def test_process_slice_matches_jax(monkeypatch, n_items, world):
    items = [f"w{i}" for i in range(n_items)]
    monkeypatch.setattr(jax, "process_count", lambda: world)
    monkeypatch.setattr(mesh, "process_count", lambda: world)
    for r in range(world):
        monkeypatch.setattr(jax, "process_index", lambda r=r: r)
        monkeypatch.setattr(mesh, "process_index", lambda r=r: r)
        assert mesh.process_slice(items) == jmesh.process_slice(items)


@pytest.mark.parametrize("n,n_dev", [(13, 4), (16, 4), (5, 8)])
def test_pad_and_shard_batch_match_jax(rng, n, n_dev):
    x = rng.rand(n, 3).astype(np.float32)
    chunks, n_pad = mesh.shard_batch(x, [CPU] * n_dev)
    xd, n_pad_j = jmesh.shard_batch(x, jmesh.make_mesh(n_dev))
    assert n_pad == n_pad_j
    assert mesh.pad_to_multiple(n, n_dev) == jmesh.pad_to_multiple(n, n_dev)
    assert len({c.shape for c in chunks}) == 1
    np.testing.assert_array_equal(torch.cat(chunks).numpy(), np.asarray(xd))


def _ring_on_ranks(z, rel, tid, n):
    """The ring loss over ``n`` thread ranks on the packed batch: each
    rank's (loss, gradient of its shard, sent bytes)."""
    packed = SL.pack_trajectories(np.arange(len(z)), tid, n)
    blocks = SL.blockdiag_relations(csr_matrix(rel), packed, n)
    b = len(z) // n
    loss_fn = SL.make_traj_sharded_tm_loss()

    def rank(comm):
        zr = torch.tensor(z[packed[comm.rank * b:(comm.rank + 1) * b]],
                          requires_grad=True)
        with mesh.collective_scope(comm):
            loss = loss_fn(zr, blocks[comm.rank * b:(comm.rank + 1) * b],
                           **W)
            loss.backward()
        return loss.item(), zr.grad.numpy(), comm.sent_bytes

    return packed, blocks, run_ranks(n, rank)


@pytest.fixture(scope="module")
def ring_problem():
    rel, tid = _traj_relations(LENGTHS)
    z = np.random.RandomState(0).randn(len(rel), 48).astype(np.float32)
    return rel, tid, z


@pytest.mark.parametrize("n", [2, 4])
def test_ring_loss_and_gradient_match_jax(ring_problem, n):
    rel, tid, z = ring_problem
    packed, blocks, outs = _ring_on_ranks(z, rel, tid, n)
    jfn = JSL.make_traj_sharded_tm_loss(jmesh.make_mesh(n))
    jloss, jgrad = jax.jit(jax.value_and_grad(
        lambda z, r: jfn(z, r, **W)))(jnp.asarray(z[packed]),
                                      jnp.asarray(blocks, jnp.float32))
    losses = [o[0] for o in outs]
    assert len(set(losses)) == 1              # replicated, bit for bit
    np.testing.assert_allclose(losses[0], float(jloss), rtol=1e-6,
                               atol=1e-7)
    grad = np.concatenate([o[1] for o in outs]) / n
    np.testing.assert_allclose(grad, np.asarray(jgrad), rtol=1e-5,
                               atol=1e-6)
    # n - 1 ring steps each way (forward, then the gradient back), each
    # sending one (b, L) fp32 shard a rank
    b = len(z) // n
    assert outs[0][2] == 2 * (n - 1) * b * z.shape[1] * 4


def test_ring_loss_equals_dense_when_shard_aligned(ring_problem):
    """LENGTHS tile 4 shards of 8 exactly: the blocked loss is the dense
    loss, and its gradient the dense gradient."""
    rel, tid, z = ring_problem
    packed, _, outs = _ring_on_ranks(z, rel, tid, 4)
    zt = torch.tensor(z[packed], requires_grad=True)
    dense = common.time_matching_loss(zt, rel[packed][:, packed], **W)
    dense.backward()
    np.testing.assert_allclose(outs[0][0], dense.item(), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(np.concatenate([o[1] for o in outs]) / 4,
                               zt.grad.numpy(), rtol=1e-5, atol=1e-6)


def _bn_net(state=None, folded=False):
    """A conv + linear net with two batch norms moved off the identity;
    with ``state``, those weights (threads share torch's seeded RNG, so
    ranks copy the main thread's net rather than draw their own). With
    ``folded`` the first is the port's ``BatchNorm2d`` with the ReLU
    folded in (the same ``state_dict``)."""
    torch.manual_seed(0)
    bn, act = (BatchNorm2d(6, relu=True), nn.Identity()) if folded else \
        (nn.BatchNorm2d(6), nn.ReLU())
    net = nn.Sequential(nn.Conv2d(2, 6, 3, padding=1), bn, act,
                        nn.Flatten(), nn.Linear(6 * 8 * 8, 5),
                        nn.BatchNorm1d(5))
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, nn.BatchNorm2d | nn.BatchNorm1d):
                m.weight.uniform_(0.5, 1.5)
                m.bias.uniform_(-0.5, 0.5)
    if state is not None:
        net.load_state_dict(state)
    return net.train()


@pytest.mark.parametrize("folded", [False, True],
                         ids=["unfolded", "folded"])
@pytest.mark.parametrize("n", [2, 4])
def test_cross_rank_batch_norm_is_the_global_batch_norm(rng, n, folded):
    """n ranks of 8 / n rows each against one net on all 8: outputs, the
    loss, the gradients averaged over the ranks and the running buffers,
    which the ranks hold bit for bit alike. ``folded``: the one net takes
    the port's ``BatchNorm2d`` (``F.batch_norm`` then ``F.relu`` on the
    CPU) and the ranks its ReLU after the global statistics, bit-equal to
    the unfolded ranks' and counted in neither of the op's counters (the
    cross-rank statistics are not ``F.batch_norm``)."""
    x = (rng.randn(8, 2, 8, 8) * 3 + 1).astype(np.float32)
    t = rng.randn(8, 5).astype(np.float32)
    one = _bn_net(folded=folded)
    state = {k: v.clone() for k, v in one.state_dict().items()}
    y1 = one(torch.from_numpy(x))
    loss = ((y1 - torch.from_numpy(t)) ** 2).mean()
    loss.backward()
    b = len(x) // n
    counted = (bn_ops.batch_norm_train.launches,
               bn_ops.batch_norm_train.fallbacks)

    def rank(comm, folded=folded):
        net = _bn_net(state, folded)
        sl = slice(comm.rank * b, (comm.rank + 1) * b)
        with mesh.collective_scope(comm), cross_rank_batch_norm(net):
            y = net(torch.from_numpy(x[sl]))
            local = mesh.global_mean(
                ((y - torch.from_numpy(t[sl])) ** 2).mean())
            local.backward()
        assert not any("forward" in vars(m) for m in net.modules())
        return (y.detach().numpy(), local.item(),
                {k: p.grad.numpy() / n for k, p in net.named_parameters()},
                {k: v.numpy() for k, v in net.state_dict().items()})

    outs = run_ranks(n, rank)
    assert (bn_ops.batch_norm_train.launches,
            bn_ops.batch_norm_train.fallbacks) == counted
    if folded:      # the ranks bit for bit as with nn.BatchNorm2d + nn.ReLU
        for a, b_ in zip(outs, run_ranks(n, lambda c: rank(c, False))):
            np.testing.assert_array_equal(a[0], b_[0])
            assert a[1] == b_[1]
            for k in a[2]:
                np.testing.assert_array_equal(a[2][k], b_[2][k])
    np.testing.assert_allclose(np.concatenate([o[0] for o in outs]),
                               y1.detach().numpy(), rtol=1e-5, atol=1e-5)
    assert len({o[1] for o in outs}) == 1
    np.testing.assert_allclose(outs[0][1], loss.item(), rtol=1e-5)
    for k, p in one.named_parameters():
        # the step's average over the ranks (each rank's own gradient holds
        # its rows' paths only)
        np.testing.assert_allclose(sum(o[2][k] for o in outs),
                                   p.grad.numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    for k, v in one.state_dict().items():
        for o in outs[1:]:
            np.testing.assert_array_equal(o[3][k], outs[0][3][k])
        np.testing.assert_allclose(outs[0][3][k], v.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("n", [2, 4])
def test_augmentation_is_the_global_batch_draw(rng, n):
    """Each rank's augmented rows (and masks) are one process's augmented
    batch, sliced: the draws are the global batch's."""
    b = 3
    x = torch.from_numpy(rng.rand(b * n, 2, 8, 8).astype(np.float32))
    m = torch.from_numpy((rng.rand(b * n, 2, 8, 8) > 0.5).astype(np.uint8))
    x1, m1 = augment_batch(x, m, generator=torch.Generator().manual_seed(11))

    def rank(comm):
        sl = slice(comm.rank * b, (comm.rank + 1) * b)
        with mesh.collective_scope(comm):
            return augment_batch(x[sl], m[sl],
                                 generator=torch.Generator().manual_seed(11))

    outs = run_ranks(n, rank)
    np.testing.assert_array_equal(torch.cat([o[0] for o in outs]), x1)
    np.testing.assert_array_equal(torch.cat([o[1] for o in outs]), m1)


def test_fit_pca_distributed_matches_jax(rng):
    x = (rng.randn(203, 12) @ rng.randn(12, 12)).astype(np.float32)
    got = fit_pca_distributed(x, 0.9, devices=[CPU, CPU, CPU])
    want = jax_fit_pca_dist(x, 0.9, mesh=jmesh.make_mesh(8))
    assert got.components_.shape == want.components_.shape
    for name in ("components_", "mean_", "explained_variance_",
                 "explained_variance_ratio_"):
        np.testing.assert_allclose(getattr(got, name),
                                   np.asarray(getattr(want, name)),
                                   atol=1e-5, rtol=1e-5, err_msg=name)
    # one device: the SVD fit, as in the JAX package
    one = fit_pca_distributed(x, 0.9, devices=[CPU])
    np.testing.assert_allclose(one.components_, got.components_, atol=1e-4)


def test_encode_patches_over_devices_matches_jax(rng):
    jmodel = JaxZ16(num_embeddings=16, num_hiddens=8,
                    num_residual_hiddens=8, vq_impl="xla")
    from test_torch_vae_family import numpy_weights

    params, state = numpy_weights(jmodel, seed=1)
    model = VQVAEz16(num_embeddings=16, num_hiddens=8,
                     num_residual_hiddens=8)
    model.load_state_dict(state_dict_from_jax(params, state, "VQ_VAE_z16"),
                          strict=True)
    dataset = rng.rand(37, 2, 64, 64).astype(np.float32)   # not divisible
    zb, za = encode_patches(model, dataset, batch_size=16, device="cpu",
                            devices=[CPU, CPU, CPU])
    jzb, jza = jax_encode(jmodel, params, state, dataset, batch_size=16,
                          mesh=jmesh.make_mesh(8))
    np.testing.assert_allclose(zb, np.asarray(jzb), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(za, np.asarray(jza), atol=1e-5, rtol=1e-5)
    zb1, za1 = encode_patches(model, dataset, batch_size=16, device="cpu")
    np.testing.assert_array_equal(zb, zb1)
    np.testing.assert_array_equal(za, za1)


def test_async_writer_takes_submits_from_threads():
    """Several threads submit through one writer: every write lands once,
    and each thread's writes land in its order."""
    landed, lock = [], threading.Lock()

    def write(tag, i):
        with lock:
            landed.append((tag, i))

    with AsyncWriter(depth=2) as writer:
        def submit(tag):
            for i in range(200):
                writer.submit(write, tag, i)

        threads = [threading.Thread(target=submit, args=(t,))
                   for t in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    assert sorted(landed) == [(t, i) for t in range(6) for i in range(200)]
    for t in range(6):
        assert [i for tag, i in landed if tag == t] == list(range(200))


class _WorldOf3:
    """A stand-in communicator of a three-rank group: the trainers check
    the batch against the world before any collective."""
    rank, world = 0, 3


def test_train_vqvae_names_the_batch_and_the_world(monkeypatch, tmp_path):
    from dynamorph_tpu_torch.train import trainer

    monkeypatch.setattr(trainer, "_data_parallel_comm", _WorldOf3)
    with pytest.raises(ValueError, match=r"batch_size 8 does not split "
                       r"evenly over the 3 ranks.*world size 3.*drop "
                       r"partial batches"):
        trainer.train_vqvae(VQVAEz16(num_hiddens=8, num_residual_hiddens=8,
                                     num_embeddings=16),
                            np.zeros((16, 2, 32, 32), np.float32),
                            str(tmp_path), batch_size=8, device="cpu")
    monkeypatch.undo()
    with pytest.raises(ValueError, match="requires a process group"):
        trainer.train_vqvae(VQVAEz16(num_hiddens=8, num_residual_hiddens=8,
                                     num_embeddings=16),
                            np.zeros((16, 2, 32, 32), np.float32),
                            str(tmp_path), relation_mat=np.eye(16),
                            batch_size=8, traj_sharded_loss=True,
                            device="cpu")


def test_train_triplet_names_the_batch_and_the_world(monkeypatch, tmp_path):
    from dynamorph_tpu_torch.models.resnet_simclr import EncodeProject
    from dynamorph_tpu_torch.train import trainer
    from dynamorph_tpu_torch.train.triplet_data import TripletDataset

    monkeypatch.setattr(trainer, "_data_parallel_comm", _WorldOf3)
    data = np.zeros((8, 2, 32, 32), np.float32)
    ds = TripletDataset(np.repeat(np.arange(4), 2), lambda i: data[i], 2)
    with pytest.raises(ValueError, match=r"a batch of 4 anchors x 2 "
                       r"samples = 8 does not split evenly over the 3 "
                       r"ranks.*drop partial batches"):
        trainer.train_triplet(EncodeProject(arch="ResNet18"), ds, ds,
                              str(tmp_path), batch_size=4, device="cpu")


@pytest.mark.parametrize("trio", [("127.0.0.1:1", None, 0),
                                  (None, 2, None), (None, None, None)])
def test_init_multihost_takes_the_trio_or_torchrun(monkeypatch, trio):
    """A partial trio raises (the JAX package's rule), as does no trio
    without torchrun's variables; neither joins a group, and outside one
    the helpers are those of a single process."""
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="together|RANK"):
        mesh.init_multihost(*trio)
    assert not mesh.is_distributed()
    assert (mesh.process_index(), mesh.process_count()) == (0, 1)
    assert mesh.allgather_flags(True) == [True]
    mesh.barrier("no group")
    assert mesh.process_slice(["a", "b"]) == ["a", "b"]
