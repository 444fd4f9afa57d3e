"""The cv2 geometry calls of the JAX package as torch functions on CPU and
CUDA tensors: ``getRotationMatrix2D``, ``warpAffine`` (INTER_LINEAR,
BORDER_CONSTANT 0), ``flip(·, 1)``, the channel-first wrapper
``cv2_fn_wrapper`` (``dynamorph_tpu/seg/data.py:47-58``) and the
one-channel ``resize`` of the validation overlays and trajectory GIFs
(uint8, uint16) and of the ImageNet baselines' inputs (float64).

``warp_affine`` reproduces the two arithmetics of the installed OpenCV
(5.0), which picks one by dtype and channel count:

- **fixed point** (float64 at any channel count; float32, uint16 and uint8
  at 2 or more than 4 channels): the inverse map's source coordinates are
  ``rint(M * 1024)`` integers plus a rounding delta of 16, shifted right by
  5, so they sit on a 1/32 pixel grid; the bilinear weights are products
  of those 1/32 fractions, summed ``((p00 w00 + p01 w01) + p10 w10) + p11
  w11`` in float64 (float64 input) or float32 (float32 and uint16), or in
  15-bit fixed point (uint8);
- **float coordinates** (float32, uint16 and uint8 at 1, 3 or 4 channels):
  the source position is computed in float32, as cv2's vector loop does
  for 16-pixel blocks (``fma(m0, x, float(y m1 + m2))``) and its scalar
  loop for the columns after the last whole block (``fma(x, m0, y m1) +
  m2``); the bilinear is two lerps ``fma(a, p1 - p0, p0)`` then one in y.

Integer outputs are rounded half to even and saturated. A tap outside the
source reads 0. The fused multiply-adds run in float64 and round once to
float32 (exact but for double rounding, which needs the float64 sum to
fall on a float32 midpoint), and every other step is one IEEE operation
per torch call, so CPU and CUDA tensors give the same bits.

Batched: ``warp_affine`` takes (N, H, W, C) tensors, or a list of them
sharing one (N, 2, 3) stack of matrices, and builds the taps of each
arithmetic once for the list.
"""
from __future__ import annotations

import math
from typing import Callable, List, Tuple

import numpy as np
import torch

_AB_SCALE = 1024        # fixed-point scale of the inverse map
_INTER_BITS = 5         # 1/32 pixel grid
_ROUND_DELTA = 16       # _AB_SCALE / 32 / 2
_VECTOR_BLOCK = 16      # pixels a vector-loop iteration of cv2 covers
_CHUNK = 64             # images warped at a time (bounds the gathers' memory)


def rotation_matrix_2d(center: Tuple[float, float], angle: float,
                       scale: float = 1.0) -> np.ndarray:
    """``cv2.getRotationMatrix2D``: the (2, 3) float64 matrix rotating by
    ``angle`` degrees (counter-clockwise on screen) about ``center``, which
    cv2 takes as float32 (``Point2f``)."""
    cx, cy = (float(np.float32(c)) for c in center)
    a = angle * (math.pi / 180)
    alpha = math.cos(a) * scale
    beta = math.sin(a) * scale
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def _invert_affine(M: np.ndarray) -> np.ndarray:
    """(..., 2, 3) -> (..., 6) float64 inverse maps, in cv2's operation
    order (warpAffine without WARP_INVERSE_MAP)."""
    M = np.asarray(M, np.float64).reshape(-1, 6)
    m0, m1, m2, m3, m4, m5 = M.T
    d = m0 * m4 - m1 * m3
    d = np.where(d != 0, 1.0 / np.where(d != 0, d, 1.0), 0.0)
    a0, a4 = m4 * d, m0 * d
    a1, a3 = m1 * -d, m3 * -d
    b1 = -a0 * m2 - a1 * m5
    b2 = -a3 * m2 - a4 * m5
    return np.stack([a0, a1, b1, a3, a4, b2], 1)


def _fma(a, b, c) -> torch.Tensor:
    """float32 fused multiply-add, computed in float64 and rounded once."""
    return (a.double() * b.double() + c.double()).float()


def _fixed_taps(inv: np.ndarray, dsize, device):
    """Integer tap corners and 1/32 fractions (N, H, W) of the fixed-point
    map."""
    w, h = dsize
    xs, ys = np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64)
    ad = np.rint(inv[:, 0, None] * xs * _AB_SCALE).astype(np.int64)
    bd = np.rint(inv[:, 3, None] * xs * _AB_SCALE).astype(np.int64)
    x0 = np.rint((inv[:, 1, None] * ys + inv[:, 2, None]) * _AB_SCALE
                 ).astype(np.int64) + _ROUND_DELTA
    y0 = np.rint((inv[:, 4, None] * ys + inv[:, 5, None]) * _AB_SCALE
                 ).astype(np.int64) + _ROUND_DELTA

    def up(a):
        return torch.from_numpy(a).to(device)

    shift = 10 - _INTER_BITS
    X = (up(x0)[:, :, None] + up(ad)[:, None, :]) >> shift
    Y = (up(y0)[:, :, None] + up(bd)[:, None, :]) >> shift
    mask = (1 << _INTER_BITS) - 1
    return X >> _INTER_BITS, Y >> _INTER_BITS, X & mask, Y & mask


def _float_taps(inv: np.ndarray, dsize, device):
    """Tap corners (N, H, W) int64 and float32 fractions of the
    float-coordinate map: cv2's vector loop on whole 16-pixel blocks, its
    scalar loop on the columns after them."""
    w, h = dsize
    mf = inv.astype(np.float32)
    yf = np.arange(h, dtype=np.float32)
    n_vec = (w // _VECTOR_BLOCK) * _VECTOR_BLOCK
    x = torch.arange(w, dtype=torch.float32, device=device)[None, None, :]
    out = []
    for k in (0, 3):
        m0, m1, m2 = (torch.from_numpy(mf[:, k + i].copy()).to(device)
                      [:, None, None] for i in range(3))
        ym = torch.from_numpy(yf[None, :] * mf[:, k + 1, None]).to(device)
        row = torch.from_numpy(yf[None, :] * mf[:, k + 1, None]
                               + mf[:, k + 2, None]).to(device)
        vec = _fma(m0, x, row[:, :, None])
        tail = _fma(x, m0, ym[:, :, None]) + m2
        out.append(torch.where(x < n_vec, vec, tail))
    sx, sy = out
    ix, iy = torch.floor(sx), torch.floor(sy)
    return ix.long(), iy.long(), sx - ix, sy - iy


def _gather4(img: torch.Tensor, ix, iy, dtype) -> List[torch.Tensor]:
    """The four taps (N, Ho, Wo, C) of each output pixel, as ``dtype``,
    0 outside the (N, H, W, C) source."""
    n, h, w, c = img.shape
    p = torch.zeros((n, h + 4, w + 4, c), dtype=dtype, device=img.device)
    p[:, 2:h + 2, 2:w + 2] = img
    base = torch.arange(n, device=img.device)[:, None, None] * \
        ((h + 4) * (w + 4))
    i00 = base + (iy.clamp(-2, h) + 2) * (w + 4) + ix.clamp(-2, w) + 2
    offs = torch.tensor([0, 1, w + 4, w + 5], device=img.device)
    idx = i00[None] + offs[:, None, None, None]
    taps = p.reshape(-1, c).index_select(0, idx.reshape(-1))
    return list(taps.reshape(idx.shape + (c,)).unbind(0))


def _round_to(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if dtype.is_floating_point:
        return v.to(dtype)
    hi = torch.iinfo(dtype).max
    return torch.round(v).clamp(0, hi).to(dtype)


def _warp_fixed(img, taps) -> torch.Tensor:
    ix, iy, fx, fy = taps
    if img.dtype == torch.uint8:        # 15-bit fixed-point weights
        w = [((32 - fy) * (32 - fx)), ((32 - fy) * fx), (fy * (32 - fx)),
             (fy * fx)]
        p = _gather4(img, ix, iy, torch.int64)
        s = sum(pk * (wk * 32)[..., None] for pk, wk in zip(p, w))
        return ((s + (1 << 14)) >> 15).clamp(0, 255).to(torch.uint8)
    wt = torch.float64 if img.dtype == torch.float64 else torch.float32
    tx, ty = fx.to(wt) / 32, fy.to(wt) / 32
    w = [(1 - ty) * (1 - tx), (1 - ty) * tx, ty * (1 - tx), ty * tx]
    p = _gather4(img, ix, iy, wt)
    v = ((p[0] * w[0][..., None] + p[1] * w[1][..., None])
         + p[2] * w[2][..., None]) + p[3] * w[3][..., None]
    return _round_to(v, img.dtype)


def _warp_float(img, taps) -> torch.Tensor:
    ix, iy, a, b = taps
    p00, p01, p10, p11 = _gather4(img, ix, iy, torch.float32)
    a, b = a[..., None], b[..., None]
    v0 = _fma(a, p01 - p00, p00)
    v1 = _fma(a, p11 - p10, p10)
    return _round_to(_fma(b, v1 - v0, v0), img.dtype)


def _uses_fixed(img: torch.Tensor) -> bool:
    return img.dtype == torch.float64 or img.shape[-1] == 2 or \
        img.shape[-1] > 4


def warp_affine(images, M, dsize: Tuple[int, int]):
    """``cv2.warpAffine(img, M, dsize)`` (INTER_LINEAR, BORDER_CONSTANT 0)
    over a batch.

    Args:
        images: an (N, H, W, C) tensor (float64, float32, uint16 or uint8),
            or a list of them with the same N, on one device.
        M: (2, 3) or (N, 2, 3) forward matrices (numpy or tensor).
        dsize: (width, height) of the output, as cv2 takes it.

    Returns the (N, height, width, C) warps, a list for a list.
    """
    single = isinstance(images, torch.Tensor)
    imgs = [images] if single else list(images)
    for im in imgs:
        if im.ndim != 4:
            raise ValueError(f"warp_affine needs (N, H, W, C), got "
                             f"{tuple(im.shape)}")
        if im.dtype not in (torch.float64, torch.float32, torch.uint16,
                            torch.uint8):
            raise TypeError(f"warp_affine does not take {im.dtype}")
    n = imgs[0].shape[0]
    M = M.cpu().numpy() if isinstance(M, torch.Tensor) else np.asarray(M)
    inv = _invert_affine(np.broadcast_to(M.reshape(-1, 2, 3), (n, 2, 3)))
    device = imgs[0].device
    w, h = dsize
    outs = [torch.empty((n, h, w, im.shape[-1]), dtype=im.dtype,
                        device=device) for im in imgs]
    for s in range(0, n, _CHUNK):
        sl = slice(s, s + _CHUNK)
        fixed = floating = None
        for im, out in zip(imgs, outs):
            if _uses_fixed(im):
                fixed = fixed or _fixed_taps(inv[sl], dsize, device)
                out[sl] = _warp_fixed(im[sl], fixed)
            else:
                floating = floating or _float_taps(inv[sl], dsize, device)
                out[sl] = _warp_float(im[sl], floating)
    return outs[0] if single else outs


def warp_image(img, M, dsize: Tuple[int, int]):
    """One image in cv2's layout, (H, W) or (H, W, C), numpy or tensor ->
    its ``cv2.warpAffine(img, M, dsize)`` in the same type."""
    is_np = not isinstance(img, torch.Tensor)
    t = torch.from_numpy(np.ascontiguousarray(img)) if is_np else img
    two_d = t.ndim == 2
    out = warp_affine(t[None, ..., None] if two_d else t[None], M, dsize)[0]
    out = out[..., 0] if two_d else out
    return out.numpy() if is_np else out


def flip(img, flip_code: int = 1):
    """``cv2.flip(img, 1)``: mirror left-right (the column axis of an
    (H, W[, C]) image)."""
    if flip_code != 1:
        raise NotImplementedError("only flip code 1 (left-right) is ported")
    if isinstance(img, torch.Tensor):
        return torch.flip(img, dims=(1,))
    return np.ascontiguousarray(np.asarray(img)[:, ::-1])


def channel_first(fn: Callable, mat, *args, **kwargs):
    """Apply a cv2-layout function over the trailing (x, y) of
    channel-first data, as ``cv2_fn_wrapper`` does: (..., X, Y) ->
    (X, Y, K) with K the product of the leading dims -> ``fn`` -> back to
    (..., X', Y')."""
    shape = tuple(mat.shape)
    x_size, y_size = shape[-2:]
    flat = mat.reshape((-1, x_size, y_size))
    hwk = flat.permute(1, 2, 0) if isinstance(flat, torch.Tensor) \
        else flat.transpose((1, 2, 0))
    out = fn(hwk, *args, **kwargs)
    if out.ndim == 2:
        out = out[:, :, None]
    out_shape = shape[:-2] + (out.shape[0], out.shape[1])
    back = out.permute(2, 0, 1) if isinstance(out, torch.Tensor) \
        else out.transpose((2, 0, 1))
    return back.reshape(out_shape)


def _resize_taps(n_src: int, n_dst: int, clamp: bool, dtype=np.float32):
    """cv2's INTER_LINEAR taps along one axis: the position ``(d + 0.5) *
    scale - 0.5`` in ``dtype``, its floor and its float32 fraction;
    ``clamp`` (cv2's fixed-point path does it along x only) pins positions
    off either end to the end pixel with fraction 0."""
    f = ((np.arange(n_dst) + 0.5) * (n_src / n_dst) - 0.5).astype(dtype)
    i = np.floor(f).astype(np.int64)
    f = (f - i.astype(dtype)).astype(np.float32)
    if clamp:
        lo, hi = i < 0, i >= n_src - 1
        f[lo | hi] = 0
        i[lo], i[hi] = 0, n_src - 1
    return np.clip(i, 0, n_src - 1), np.clip(i + 1, 0, n_src - 1), f


def resize(img: np.ndarray, dsize: Tuple[int, int],
           interpolation: str = "linear") -> np.ndarray:
    """``cv2.resize(img, dsize, interpolation=...)`` of a 2-D uint8,
    uint16 or float64 image (host numpy; ``dsize`` is (width, height)).

    - "nearest": source index ``min(floor(d * src / dst), src - 1)``;
    - "linear" on uint8: cv2's fixed point, 11-bit weights
      ``rint((1 - f) * 2048)`` and ``rint(f * 2048)`` from float32
      fractions, the horizontal sums kept as int, the vertical pass as its
      vector loop rounds them, ``((S0 >> 4) * b0 >> 16) + ((S1 >> 4) * b1
      >> 16) + 2 >> 2``;
    - "linear" on uint16: float64 positions, float32 fractions ``f``, a
      lerp ``fma(f, S1 - S0, S0)`` in float32 along x, then along y,
      rounded half to even (cv2 5.0's one-channel 16-bit path);
    - "linear" on float64: cv2 5.0's double path, all in float64: the
      position ``fma(d + 0.5, scale, -0.5)``, its fraction ``f`` (0 where
      the position lies off either end, which pins it to the end pixel),
      and ``fma(f, S1 - S0, S0)`` along x, then along y, each fused
      multiply-add rounded once (``native/fma.cpp``). Bit-equal to cv2 on
      images of at least 2 x 2 pixels (a single row or column takes
      another path in cv2, within 5e-8 relative of this one).
    """
    img = np.asarray(img)
    dst_w, dst_h = dsize
    h, w = img.shape
    if interpolation == "nearest":
        sx = np.minimum(np.floor(np.arange(dst_w) * (1.0 / (dst_w / w)))
                        .astype(np.int64), w - 1)
        sy = np.minimum(np.floor(np.arange(dst_h) * (1.0 / (dst_h / h)))
                        .astype(np.int64), h - 1)
        return img[sy][:, sx]
    if interpolation != "linear":
        raise ValueError(f"unknown interpolation {interpolation!r}")
    if img.dtype == np.uint8:
        x0, x1, fx = _resize_taps(w, dst_w, clamp=True)
        y0, y1, fy = _resize_taps(h, dst_h, clamp=False)

        def coef(f):
            return (np.rint((np.float32(1) - f) * np.float32(2048))
                    .astype(np.int64),
                    np.rint(f * np.float32(2048)).astype(np.int64))

        (a0, a1), (b0, b1) = coef(fx), coef(fy)
        im = img.astype(np.int64)
        hor = im[:, x0] * a0 + im[:, x1] * a1
        s0, s1 = hor[y0] >> 4, hor[y1] >> 4
        v = (((s0 * b0[:, None]) >> 16) + ((s1 * b1[:, None]) >> 16) + 2) >> 2
        return np.clip(v, 0, 255).astype(np.uint8)
    if img.dtype == np.float64:
        return _resize_linear_f64(img, dst_w, dst_h)
    if img.dtype != np.uint16:
        raise TypeError(f"resize takes uint8, uint16 or float64, not "
                        f"{img.dtype}")
    x0, x1, fx = _resize_taps(w, dst_w, clamp=False, dtype=np.float64)
    y0, y1, fy = _resize_taps(h, dst_h, clamp=False, dtype=np.float64)

    def lerp(f, s0, s1):                 # fma in float64, one rounding
        return (f.astype(np.float64) * (s1 - s0) + s0).astype(np.float32)

    im = img.astype(np.float32)
    hor = lerp(fx, im[:, x0], im[:, x1])
    v = lerp(fy[:, None], hor[y0], hor[y1])
    return np.clip(np.rint(v), 0, 65535).astype(np.uint16)


def _resize_linear_f64(img: np.ndarray, dst_w: int, dst_h: int
                       ) -> np.ndarray:
    """cv2 5.0's float64 INTER_LINEAR (``resize``'s docstring)."""
    from ..native.fma import fma

    def taps(n_src, n_dst):
        p = fma(np.arange(n_dst) + 0.5, n_src / n_dst, -0.5)
        i = np.floor(p).astype(np.int64)
        f = p - i
        off = (i < 0) | (i >= n_src - 1)
        f[off] = 0
        i = np.clip(i, 0, n_src - 1)
        return i, np.minimum(i + 1, n_src - 1), f

    h, w = img.shape
    x0, x1, fx = taps(w, dst_w)
    y0, y1, fy = taps(h, dst_h)
    hor = fma(fx, img[:, x1] - img[:, x0], img[:, x0])
    return fma(fy[:, None], hor[y1] - hor[y0], hor[y0])
