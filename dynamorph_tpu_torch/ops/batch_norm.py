"""Training-mode batch norm of NCHW activations, with an optional ReLU
folded in.

``batch_norm_train`` normalises each channel with the batch's mean and
biased variance, updates the running buffers as torch does (``momentum``
the factor, unbiased variance) and, with ``relu``, applies ``max(y, 0)``:
the function of ``F.batch_norm(training=True)`` followed by ``F.relu``.

- A CUDA float32 input runs the hand-written kernels of
  ``csrc/batch_norm.cu`` (forward and backward through
  ``torch.autograd.Function``; the backward rebuilds the ReLU mask from x
  and the saved statistics, so y is not kept). They take NCHW-contiguous
  tensors: an input in another layout is copied to it first, and y and dx
  come back NCHW-contiguous. Inputs the kernels cannot take (not 4-d, one
  value a channel, past their 32-bit indices, parameters or buffers that
  are missing or not contiguous float32 (C,) on x's device) raise
  ``ValueError``; nothing on the card falls back.
- Any other input (the CPU, float64) runs ``batch_norm_train_reference``,
  the plain PyTorch version, which is ``F.batch_norm`` (+ ``F.relu``)
  itself.

A data-parallel step never reaches this function in training mode: under
``nn.batchnorm.cross_rank_batch_norm`` its modules take the global batch's
statistics instead.

``batch_norm_train.launches`` counts the calls that ran the kernels (one
launch forward and one backward each) and ``batch_norm_train.fallbacks``
those that ran the reference, so a run can show which path its batch norms
took. Nothing is built at import: the first kernel call builds the library
(``ops/_build.py``).
"""
from __future__ import annotations

import ctypes
import functools

import torch
from torch.nn import functional as F

# a channel's n * h * w and the planes n * c must fit the kernels' 32-bit
# indices, with room for a thread's last batch of units past the end
_MAX_COUNT = 2 ** 31 - 2 ** 16


def batch_norm_train_reference(x, weight, bias, running_mean, running_var,
                               momentum: float, eps: float,
                               relu: bool = False) -> torch.Tensor:
    """Plain version: ``F.batch_norm`` in training mode (the running
    buffers updated in place), then ``F.relu`` where ``relu``."""
    y = F.batch_norm(x, running_mean, running_var, weight, bias, True,
                     momentum, eps)
    return F.relu(y) if relu else y


def _checked(x, weight, bias, running_mean, running_var):
    """``x`` NCHW-contiguous for the kernels, or ``ValueError`` where they
    cannot take these tensors."""
    if x.dim() != 4:
        raise ValueError(f"batch_norm_train: expected a 4-d (N, C, H, W) "
                         f"input, got {x.dim()}-d")
    n, c, h, w = x.shape
    if n * h * w < 2:      # F.batch_norm's refusal, in its words
        raise ValueError(f"Expected more than 1 value per channel when "
                         f"training, got input size {x.size()}")
    if n * h * w > _MAX_COUNT or n * c > _MAX_COUNT:
        raise ValueError(f"batch_norm_train: {tuple(x.shape)} is past the "
                         f"kernels' 32-bit indices")
    for name, t in (("weight", weight), ("bias", bias),
                    ("running_mean", running_mean),
                    ("running_var", running_var)):
        if not (t is not None and t.device == x.device and
                t.dtype == torch.float32 and t.is_contiguous() and
                t.shape == (c,)):
            raise ValueError(f"batch_norm_train: {name} must be a "
                             f"contiguous float32 ({c},) tensor on "
                             f"{x.device}")
    return x.contiguous()


@functools.cache
def _kernel(entry: str):
    """A C entry point of ``csrc/batch_norm.cu``, built at first use, with
    its signature declared."""
    from ._build import load

    ptr, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    argtypes = {
        "batch_norm_fwd_f32": [ptr] * 9 + [i] * 4 + [d, d, i, ptr],
        "batch_norm_bwd_f32": [ptr] * 10 + [i] * 5 + [ptr],
        "batch_norm_max_blocks": [ctypes.POINTER(ctypes.c_int)],
    }[entry]
    fn = getattr(load("batch_norm"), entry)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _max_blocks(device: torch.device) -> int:
    """The most blocks a cooperative launch of the kernels may hold on
    ``device``."""
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = _kernel("batch_norm_max_blocks")(ctypes.byref(blocks))
    if err != 0 or blocks.value < 1:
        raise RuntimeError(f"batch_norm occupancy query failed: cudaError "
                           f"{err}, {blocks.value} blocks")
    return blocks.value


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {err}")


def _forward_cuda(x, weight, bias, running_mean, running_var, momentum,
                  eps, relu, blocks):
    """The forward kernel on NCHW-contiguous ``x``: (y, mean, invstd), the
    running buffers updated in place."""
    n, c, h, w = x.shape
    y = torch.empty_like(x)
    mean = torch.empty((c,), dtype=torch.float32, device=x.device)
    invstd = torch.empty_like(mean)
    ws = torch.empty(((blocks + c) * 3,), dtype=torch.float64,
                     device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _check(_kernel("batch_norm_fwd_f32")(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
            mean.data_ptr(), invstd.data_ptr(), running_mean.data_ptr(),
            running_var.data_ptr(), ws.data_ptr(), n, c, h * w, blocks,
            float(momentum), float(eps), int(relu), stream),
            "batch_norm forward")
    return y, mean, invstd


def _backward_cuda(x, dy, mean, invstd, weight, bias, relu, blocks):
    """The backward kernel on NCHW-contiguous ``x``: (dx, dweight, dbias),
    ``dy`` made NCHW-contiguous first."""
    n, c, h, w = x.shape
    dy = dy.contiguous()
    dx = torch.empty_like(x)
    dweight = torch.empty_like(weight)
    dbias = torch.empty_like(bias)
    ws = torch.empty(((blocks + c) * 2,), dtype=torch.float64,
                     device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _check(_kernel("batch_norm_bwd_f32")(
            x.data_ptr(), dy.data_ptr(), mean.data_ptr(), invstd.data_ptr(),
            weight.data_ptr(), bias.data_ptr(), dx.data_ptr(),
            dweight.data_ptr(), dbias.data_ptr(), ws.data_ptr(), n, c,
            h * w, blocks, int(relu), stream), "batch_norm backward")
    return dx, dweight, dbias


def _blocks(x) -> int:
    """The grid of both kernels for ``x``: at most one block a plane."""
    n, c = x.shape[:2]
    return min(n * c, _max_blocks(x.device))


class _BatchNormTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, momentum,
                eps, relu):
        blocks = _blocks(x)
        y, mean, invstd = _forward_cuda(x, weight, bias, running_mean,
                                        running_var, momentum, eps, relu,
                                        blocks)
        ctx.save_for_backward(x, weight, bias, mean, invstd)
        ctx.blocks, ctx.relu = blocks, relu
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, bias, mean, invstd = ctx.saved_tensors
        dx, dweight, dbias = _backward_cuda(x, dy, mean, invstd, weight,
                                            bias, ctx.relu, ctx.blocks)
        return dx, dweight, dbias, None, None, None, None, None


def batch_norm_train(x, weight, bias, running_mean, running_var,
                     momentum: float, eps: float,
                     relu: bool = False) -> torch.Tensor:
    """Training-mode batch norm of ``x`` (N, C, H, W), then ReLU where
    ``relu``: y (N, C, H, W). ``running_mean`` and ``running_var`` (C,) are
    updated in place with the factor ``momentum``; ``weight`` and ``bias``
    (C,) are the affine scale and shift. The kernels for a CUDA float32
    ``x``, ``batch_norm_train_reference`` for any other."""
    if x.is_cuda and x.dtype == torch.float32:
        x = _checked(x, weight, bias, running_mean, running_var)
        y = _BatchNormTrain.apply(x, weight, bias, running_mean,
                                  running_var, momentum, eps, relu)
        batch_norm_train.launches += 1
        return y
    batch_norm_train.fallbacks += 1
    return batch_norm_train_reference(x, weight, bias, running_mean,
                                      running_var, momentum, eps, relu)


batch_norm_train.launches = 0
batch_norm_train.fallbacks = 0
