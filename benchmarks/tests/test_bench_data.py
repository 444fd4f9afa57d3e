"""Inputs from the seed: the same seed gives the same inputs, every seed
the same amount of work."""
import numpy as np
import torch

import bench_tiny  # noqa: F401
from reference import vqvae as ref
from yardstick import data as D

BIG = 2 ** 31 + 4099


def test_lengths_fixed_multiset():
    a = D.trajectory_lengths(18432, 4, 32, BIG)
    b = D.trajectory_lengths(18432, 4, 32, 7)
    assert sum(a) == 18432 and sorted(a) == sorted(b) and a != b
    assert min(a) >= 4 and max(a) <= 32
    assert D.trajectory_lengths(18432, 4, 32, BIG) == a


def test_relations():
    rel = D.relations([3, 2]).toarray()
    expect = np.array([[0, 2, 1, 0, 0], [2, 0, 2, 0, 0], [1, 2, 0, 0, 0],
                       [0, 0, 0, 0, 2], [0, 0, 0, 2, 0]])
    assert (rel == expect).all()
    assert (ref.trajectory_ids([3, 2]) == [0, 0, 0, 1, 1]).all()


def test_same_seed_same_inputs():
    lengths = D.trajectory_lengths(40, 4, 8, BIG)
    a = D.patches(lengths, 16, BIG, "cpu")
    b = D.patches(lengths, 16, BIG, "cpu")
    c = D.patches(lengths, 16, BIG + 1, "cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.shape == (40, 2, 16, 16) and a.dtype == torch.float32
    cfg = dict(network="VQ_VAE_z16", num_inputs=2, num_hiddens=16,
               num_residual_hiddens=32, num_residual_layers=2,
               num_embeddings=64)
    wa = D.weights(ref.param_specs(cfg), BIG, "cpu")
    wb = D.weights(ref.param_specs(cfg), BIG, "cpu")
    assert all(torch.equal(wa[k], wb[k]) for k in wa)
    assert float(wa["vq.w.weight"].abs().max()) <= 1 / 64


def test_epoch_batches_split_and_pack():
    n, traj = 200, ref.trajectory_ids([7] * 20 + [60])
    cfg = {"batch_size": 16, "val_split_ratio": 0.15}
    train, val = ref.split_ids(n, 0.15, 3)
    assert len(val) == 30 and len(train) == 170
    assert (np.diff(val) == 1).all()
    one, one_val = ref.epoch_batches(n, cfg, 1, 3, traj)
    assert [len(b) for b in one] == [16] * 10 + [10]
    assert (np.concatenate(one) == train).all()
    assert [len(b) for b in one_val] == [16, 14]
    assert (np.concatenate(one_val) == val).all()
    four, four_val = ref.epoch_batches(n, cfg, 4, 3, traj)
    assert len(four) == 2 and four_val == []
    for b, plain in zip(four, [train[:64], train[64:128]]):
        assert sorted(b) == sorted(plain)


def test_pack_agrees_with_the_program():
    """The reference's packing is the program's documented rule: the two
    give the same order (the test may import the program; the reference
    may not)."""
    from dynamorph_tpu_torch.train.sharded_loss import pack_trajectories
    rng = np.random.default_rng(5)
    for _ in range(20):
        lengths = rng.integers(1, 40, 30)
        traj = ref.trajectory_ids(lengths)
        start = int(rng.integers(0, len(traj) - 96))
        bids = np.arange(start, start + 96)
        assert (ref.pack(bids, traj, 4) ==
                pack_trajectories(bids, traj, 4)).all()
