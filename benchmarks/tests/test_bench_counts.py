"""The yardstick's operation and byte counts against hand counts at small
shapes, and the trace reader's arithmetic."""
import numpy as np
import pytest

import bench_tiny  # noqa: F401  (puts the benchmark on sys.path)
from yardstick import roofline, trace

Z16 = dict(network="VQ_VAE_z16", num_inputs=2, num_hiddens=16,
           num_residual_hiddens=32, num_residual_layers=2,
           num_embeddings=64)
Z32 = dict(Z16, network="VQ_VAE_z32", num_hiddens=64,
           num_residual_hiddens=64, num_embeddings=512)


def test_conv_flops_by_hand():
    # 1 image, 2 -> 3 channels, 4x4 stride 2 pad 1 over 8x8: out 4x4
    ops, out = roofline.conv_flops("conv", 1, 2, 3, 4, 2, 1, 8, 8)
    assert out == (4, 4) and ops == 2 * 3 * 16 * 2 * 16
    # the transposed conv back: every input pixel meets cout x k^2 taps
    ops, out = roofline.conv_flops("convT", 1, 3, 2, 4, 2, 1, 4, 4)
    assert out == (8, 8) and ops == 2 * 3 * 16 * 2 * 16


def test_bounds_by_hand():
    sec, what = roofline.indices_bound(1000, 16, 64)
    assert what == "operations"
    assert sec == pytest.approx(2 * 1000 * 64 * 16 / 67e12)
    sec, what = roofline.indices_bound(1000, 16, 1)
    assert what == "bytes"
    assert sec == pytest.approx(4 * (1000 * 16 + 16 + 1000) / 3.35e12)
    sec, _ = roofline.vq_bound(10, 4, 3)
    assert sec == pytest.approx(
        max(4 * (40 + 12 + 40 + 10) / 3.35e12,
            (2 * 10 * 3 * 4 + 2 * 3 * 4) / 67e12))


def test_z16_forward_by_hand():
    """z16 over one 16 x 16 patch: latent 2 x 2 x 16."""
    size, n = 16, 1
    convs = [  # (cin, cout, k, out h)
        (2, 8, 1, 16), (8, 8, 4, 8), (8, 16, 4, 4), (16, 16, 4, 2),
        (16, 16, 3, 2),
        (16, 32, 3, 2), (32, 16, 1, 2), (16, 32, 3, 2), (32, 16, 1, 2),
        (4, 2, 1, 16)]
    fwd = sum(2 * co * h * h * ci * k * k for ci, co, k, h in convs)
    convt = [(16, 8, 2), (8, 4, 4), (4, 4, 8)]   # (cin, cout, in h)
    fwd += sum(2 * ci * h * h * co * 16 for ci, co, h in convt)
    codes = 2 * 4 * 64 * 16
    gram = 2 * n * n * 4 * 16
    assert roofline.latent_grid(Z16, size) == (2, 2)
    assert roofline.batch_flops(Z16, n, size, False) == fwd + codes + gram
    first = 2 * 8 * 16 * 16 * 2
    assert roofline.batch_flops(Z16, n, size, True) == \
        3 * fwd - first + codes + 2 * gram


def test_batch_flops_grow_with_rows():
    """Convolutions and codes grow with the rows, the Gram product with
    their square."""
    one = roofline.batch_flops(Z32, 1, 128, True)
    two = roofline.batch_flops(Z32, 2, 128, True)
    gram = 2 * 32 * 32 * 64
    assert two - 2 * one == 2 * gram * (4 - 2)
    assert roofline.epoch_flops(Z32, [2, 1], [1], 128) == \
        two + one + roofline.batch_flops(Z32, 1, 128, False)


def test_union_and_gaps():
    iv = np.array([[5, 7], [0, 2], [1, 3], [7, 8], [10, 12]])
    u = trace._union(iv)
    assert u.tolist() == [[0, 3], [5, 8], [10, 12]]
    assert trace._union(np.zeros((0, 2), np.int64)).shape == (0, 2)


@pytest.mark.parametrize("name,fam", [
    ("vq_indices_kernel<64>", "vq_indices kernel"),
    ("cudnn::bn_fw_tr_1C11_kernel_NCHW", "batch norm"),
    ("sm90_xmma_fprop_implicit_gemm", "convolutions (cuDNN)"),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL", "nccl"),
    ("void at::native::vectorized_elementwise_kernel", trace.OTHER),
])
def test_families(name, fam):
    assert trace.family(name) == fam
