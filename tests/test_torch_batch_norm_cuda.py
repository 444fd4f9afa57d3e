"""The batch-norm kernels (``ops/csrc/batch_norm.cu``) on the card: y, the
saved statistics, the running buffers, dx, dgamma and dbeta against a
float64 ``F.batch_norm`` (+ ReLU), at the VQ-VAEs' training shapes and
ragged ones, with and without the folded ReLU; two runs bit-equal; and the
kernel's error no larger than cuDNN's (``F.batch_norm`` in fp32 on the
card) against the same float64.

Where the ReLU is folded, each fp32 side is held against float64 taken on
that side's own mask (``y > 0``): an input within rounding of the kink
takes its side from rounding, and its gradient then differs by the whole
of dy.

This file imports neither jax nor the JAX package, so it also runs on a GPU
host without them:
``python -m pytest --noconftest tests/test_torch_batch_norm_cuda.py``.
Without a card every test skips.
"""
import numpy as np
import pytest
import torch
from torch.nn import functional as F

from dynamorph_tpu_torch.models import VQVAEz16, VQVAEz32
from dynamorph_tpu_torch.nn.batchnorm import BatchNorm2d
from dynamorph_tpu_torch.ops import batch_norm as bn_ops

# z32's (enc.1, dec.2; then enc.4 and the residual stacks) and z16's
# (enc.2; the residual stacks' first batch norms), NCHW as both trunks run
TRAIN_SHAPES = [(768, 32, 64, 64), (768, 64, 32, 32), (768, 8, 64, 64),
                (768, 32, 16, 16)]
# N = 1, C = 1, H*W = 1, H*W = 63 as 63 x 1 and 7 x 9, H*W = 4 x 3
RAGGED = [(1, 5, 16, 16), (64, 1, 8, 8), (300, 6, 1, 1), (9, 3, 63, 1),
          (9, 3, 7, 9), (33, 7, 4, 3)]
MOMENTUM, EPS = 0.1, 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the batch-norm kernels run only "
                    "on the card")
    return torch.device("cuda")


def _inputs(shape, dev, offset=2.0, misaligned=False):
    """x (mean ``offset`` times its std of 1.5 on some channels), dy, and
    gamma, beta and running buffers moved off the identity, NCHW. With
    ``misaligned`` x and dy start 4 bytes past a 16-byte boundary, so the
    kernels read one float at a time."""
    n, c, h, w = shape
    r = np.random.RandomState(n + 7 * c + h * w)
    centre = offset * 1.5 * r.choice([-1.0, 0.0, 1.0], c)[:, None, None]
    x = (r.randn(*shape) * 1.5 + centre).astype(np.float32)
    dy = r.randn(*shape).astype(np.float32)
    params = [(0.5 + r.rand(c)), r.randn(c) * 0.5, r.randn(c),
              0.5 + r.rand(c)]
    tensors = []
    for a in (x, dy):
        t = torch.from_numpy(a).to(dev)
        if misaligned:
            flat = torch.empty(t.numel() + 1, device=dev)[1:]
            t = flat.view(shape).copy_(t)
        tensors.append(t)
    return tensors + [torch.tensor(p, dtype=torch.float32, device=dev)
                      for p in params]


def _float64(x, dy, gamma, beta, rmean, rvar, relu, mask=None):
    """F.batch_norm in float64 on the card: (y, mean, invstd, running mean,
    running var, dx, dgamma, dbeta); the ReLU takes ``mask`` if given."""
    xd = x.double().requires_grad_(True)
    g = gamma.double().requires_grad_(True)
    b = beta.double().requires_grad_(True)
    rm, rv = rmean.double(), rvar.double()
    y = F.batch_norm(xd, rm, rv, g, b, True, MOMENTUM, EPS)
    if relu:
        y = y * mask.double() if mask is not None else F.relu(y)
    (y * dy.double()).sum().backward()
    mean = xd.detach().mean((0, 2, 3))
    var = xd.detach().var((0, 2, 3), unbiased=False)
    return (y.detach(), mean, 1.0 / torch.sqrt(var + EPS), rm, rv,
            xd.grad, g.grad, b.grad)


def _kernel(x, dy, gamma, beta, rmean, rvar, relu):
    """The two kernels as the autograd function runs them: (y, mean,
    invstd, running mean, running var, dx, dgamma, dbeta)."""
    rm, rv = rmean.clone(), rvar.clone()
    blocks = bn_ops._blocks(x)
    y, mean, invstd = bn_ops._forward_cuda(x, gamma, beta, rm, rv, MOMENTUM,
                                           EPS, relu, blocks)
    dx, dg, db = bn_ops._backward_cuda(x, dy, mean, invstd, gamma, beta,
                                       relu, blocks)
    torch.cuda.synchronize()
    return y, mean, invstd, rm, rv, dx, dg, db


def _cudnn(x, dy, gamma, beta, rmean, rvar, relu):
    """torch's own fp32 batch norm on the card (cuDNN), then F.relu."""
    xg = x.clone().requires_grad_(True)
    g = gamma.clone().requires_grad_(True)
    b = beta.clone().requires_grad_(True)
    rm, rv = rmean.clone(), rvar.clone()
    y = F.batch_norm(xg, rm, rv, g, b, True, MOMENTUM, EPS)
    if relu:
        y = F.relu(y)
    (y * dy).sum().backward()
    torch.cuda.synchronize()
    return y.detach(), rm, rv, xg.grad, g.grad, b.grad


def _rel(a, b):
    """Relative L2 error of a against float64 b."""
    b = b.double()
    return float(torch.linalg.vector_norm(a.double() - b) /
                 max(float(torch.linalg.vector_norm(b)), 1e-300))


def _shape_id(shape):
    return "x".join(map(str, shape))


@pytest.mark.cuda
@pytest.mark.parametrize("relu", [False, True], ids=["plain", "relu"])
@pytest.mark.parametrize("shape", TRAIN_SHAPES + RAGGED, ids=_shape_id)
def test_kernels_against_float64(cuda, shape, relu):
    """Every output within fp32 rounding of float64 (relative L2 1e-6 for
    y, the statistics and the running buffers, 1e-5 for the gradients, whose
    sums cancel), and no further from it than cuDNN's, each on its own side
    of the ReLU."""
    ins = _inputs(shape, cuda)
    ours = _kernel(*ins, relu)
    mask = ours[0] > 0 if relu else None
    ref = _float64(*ins, relu, mask)
    names = ("y", "mean", "invstd", "running_mean", "running_var", "dx",
             "dgamma", "dbeta")
    limits = (1e-6,) * 5 + (1e-5,) * 3
    errs = {k: _rel(a, b) for k, a, b in zip(names, ours, ref)}
    for k, limit in zip(names, limits):
        assert errs[k] <= limit, (k, errs[k])
    cudnn = _cudnn(*ins, relu)
    ref_c = _float64(*ins, relu, cudnn[0] > 0 if relu else None)
    cudnn_errs = {k: _rel(a, ref_c[names.index(k)]) for k, a in zip(
        ("y", "running_mean", "running_var", "dx", "dgamma", "dbeta"),
        cudnn)}
    for k, e in cudnn_errs.items():
        # a floor of a few fp32 ulps where cuDNN's own error is below them
        assert errs[k] <= max(e, 2e-7), (k, errs[k], e)


@pytest.mark.cuda
@pytest.mark.parametrize("relu", [False, True], ids=["plain", "relu"])
@pytest.mark.parametrize("shape", [TRAIN_SHAPES[1], TRAIN_SHAPES[-1],
                                   RAGGED[4]], ids=_shape_id)
def test_kernels_repeat_bit_for_bit(cuda, shape, relu):
    ins = _inputs(shape, cuda)
    first, second = _kernel(*ins, relu), _kernel(*ins, relu)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("relu", [False, True], ids=["plain", "relu"])
def test_misaligned_and_off_centre(cuda, relu):
    """A tensor 4 bytes off a 16-byte boundary (one float at a time) with
    a mean 1000 times its std on some channels, where E[x^2] - E[x]^2 in
    fp32 would lose every digit of the variance: the statistics within
    1e-6 of float64; y and the gradients within 1e-4, since the fp32 mean
    alone is 6e-5 (half an ulp of 1500) from the true one, 4e-5 of the
    std."""
    shape = (96, 8, 32, 32)
    ins = _inputs(shape, cuda, offset=1000.0, misaligned=True)
    assert ins[0].data_ptr() % 16 == 4
    ours = _kernel(*ins, relu)
    ref = _float64(*ins, relu, ours[0] > 0 if relu else None)
    names = ("y", "mean", "invstd", "running_mean", "running_var", "dx",
             "dgamma", "dbeta")
    for k, a, b in zip(names, ours, ref):
        limit = 1e-6 if k in ("mean", "invstd", "running_mean",
                              "running_var") else 1e-4
        assert _rel(a, b) <= limit, (k, _rel(a, b))


def _through_autograd(x, dy, gamma, beta, rmean, rvar, relu):
    """batch_norm_train with autograd on x's own strides: (y, running
    mean, running var, dx, dgamma, dbeta) and the (launches, fallbacks)
    it counted."""
    counters = bn_ops.batch_norm_train
    before = counters.launches, counters.fallbacks
    xg = x.detach().requires_grad_(True)
    g = gamma.clone().requires_grad_(True)
    b = beta.clone().requires_grad_(True)
    rm, rv = rmean.clone(), rvar.clone()
    y = bn_ops.batch_norm_train(xg, g, b, rm, rv, MOMENTUM, EPS, relu)
    (y * dy).sum().backward()
    counted = (counters.launches - before[0], counters.fallbacks - before[1])
    return (y.detach(), rm, rv, xg.grad, g.grad, b.grad), counted


@pytest.mark.cuda
@pytest.mark.parametrize("relu", [False, True], ids=["plain", "relu"])
@pytest.mark.parametrize("layout", ["channels_last", "strided", "transposed"])
def test_other_layouts_run_the_kernels_on_a_copy(cuda, layout, relu):
    """An input on the card in another layout (channels-last, every other
    column of a wider tensor, H and W swapped in memory) is copied to NCHW
    and runs the kernels, never F.batch_norm: every output bit-equal to the
    NCHW input's, y NCHW-contiguous (dx takes the layout autograd gives a
    leaf's gradient)."""
    shape = (24, 8, 9, 12)
    x, dy, *params = _inputs(shape, cuda)
    if layout == "channels_last":
        other = x.contiguous(memory_format=torch.channels_last)
    elif layout == "strided":
        wide = torch.zeros(shape[:3] + (2 * shape[3],), device=cuda)
        wide[..., ::2] = x
        other = wide[..., ::2]
    else:
        other = x.transpose(2, 3).contiguous().transpose(2, 3)
    assert not other.is_contiguous() and torch.equal(other, x)
    want, counted = _through_autograd(x, dy, *params, relu)
    assert counted == (1, 0)
    got, counted = _through_autograd(other, dy, *params, relu)
    assert counted == (1, 0)
    for a, b in zip(got, want, strict=True):
        assert torch.equal(a, b)
    assert got[0].is_contiguous()


@pytest.mark.cuda
def test_what_the_kernels_cannot_take(cuda):
    """On the card nothing in float32 falls back: one value a channel,
    and parameters or buffers missing, of another dtype, shape or device,
    raise ValueError; float64 runs F.batch_norm, counted as a fallback."""
    x, dy, gamma, beta, rmean, rvar = _inputs((4, 3, 5, 5), cuda)

    def call(x=x, gamma=gamma, beta=beta, rmean=rmean, rvar=rvar):
        return bn_ops.batch_norm_train(x, gamma, beta, rmean, rvar,
                                       MOMENTUM, EPS, True)

    with pytest.raises(ValueError, match="more than 1 value"):
        call(x=x[:1, :, :1, :1])
    with pytest.raises(ValueError, match="4-d"):
        call(x=x[:, :, 0])
    for bad in (dict(gamma=None), dict(beta=beta.double()),
                dict(rmean=rmean[:2]), dict(rvar=rvar.cpu()),
                dict(rmean=torch.zeros(6, device=cuda)[::2])):
        with pytest.raises(ValueError, match="contiguous float32"):
            call(**bad)
    counters = bn_ops.batch_norm_train
    before = counters.launches, counters.fallbacks
    y = call(x.double(), gamma.double(), beta.double(), rmean.double(),
             rvar.double())
    assert (counters.launches, counters.fallbacks) == \
        (before[0], before[1] + 1)
    assert y.dtype == torch.float64


@pytest.mark.cuda
@pytest.mark.parametrize("relu", [False, True], ids=["plain", "relu"])
def test_module_through_autograd(cuda, relu):
    """The port's BatchNorm2d in training mode on the card: one launch
    counted, the output, the gradients and the running buffers as the
    kernels give them, num_batches_tracked moved; eval mode launches
    nothing."""
    shape = (128, 16, 16, 16)
    x, dy, gamma, beta, rmean, rvar = _inputs(shape, cuda)
    m = BatchNorm2d(16, relu=relu).to(cuda).train()
    with torch.no_grad():
        m.weight.copy_(gamma)
        m.bias.copy_(beta)
        m.running_mean.copy_(rmean)
        m.running_var.copy_(rvar)
    xg = x.clone().requires_grad_(True)
    before = bn_ops.batch_norm_train.launches
    y = m(xg)
    (y * dy).sum().backward()
    assert bn_ops.batch_norm_train.launches == before + 1
    want = _kernel(x, dy, gamma, beta, rmean, rvar, relu)
    for a, b in ((y, want[0]), (m.running_mean, want[3]),
                 (m.running_var, want[4]), (xg.grad, want[5]),
                 (m.weight.grad, want[6]), (m.bias.grad, want[7])):
        assert torch.equal(a.detach(), b)
    assert int(m.num_batches_tracked) == 1
    with torch.no_grad():
        m.eval()(x)
    assert bn_ops.batch_norm_train.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("cls,count", [(VQVAEz32, 11), (VQVAEz16, 8)],
                         ids=["z32", "z16"])
def test_models_take_the_kernels(cuda, cls, count):
    """A training step of each VQ-VAE runs every batch norm through the
    kernels (11 for z32, 8 for z16) and none through F.batch_norm, each on
    an NCHW-contiguous input (no copy: z16's fused stem hands its trunk
    NCHW on the card); its losses match the CPU's within fp32 rounding."""
    def model():
        torch.manual_seed(0)
        return cls(num_hiddens=16, num_residual_hiddens=8,
                   num_embeddings=32)

    x = torch.from_numpy(np.random.RandomState(0).randn(
        16, 2, 64, 64).astype(np.float32))
    _, cpu_losses = model().apply(x, train=True)
    card = model().to(cuda)
    layouts = []
    for m in card.modules():
        if isinstance(m, BatchNorm2d):
            m.register_forward_pre_hook(
                lambda m, args: layouts.append(args[0].is_contiguous()))
    counters = bn_ops.batch_norm_train
    launches, fallbacks = counters.launches, counters.fallbacks
    _, losses = card.apply(x.to(cuda), train=True)
    losses["total_loss"].backward()
    assert (counters.launches - launches,
            counters.fallbacks - fallbacks) == (count, 0)
    assert layouts == [True] * count
    # a code may change hands at a near-tie between the two
    np.testing.assert_allclose(losses["recon_loss"].detach().item(),
                               cpu_losses["recon_loss"].detach().item(),
                               rtol=1e-3)
