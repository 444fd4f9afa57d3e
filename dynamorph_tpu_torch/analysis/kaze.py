"""KAZE features without cv2: OpenCV's ``KAZEFeatures``
(modules/features2d/src/kaze/) at ``cv2.KAZE_create()``'s defaults
(``extended=False``: 64-d descriptors, ``upright=False``, ``threshold=
0.001``, 4 octaves of 4 sublevels, ``DIFF_PM_G2``), in torch on an explicit
device, in float32 as OpenCV computes it.

- The nonlinear scale space (``KAZEFeatures::Create_Nonlinear_Scale_Space``):
  the uint8 image over 255; ``gaussian_2D_convolution`` at ``soffset`` 1.6
  (``GaussianBlur``, kernel size ``ceil(2 (1 + (sigma - 0.8) / 0.3))``
  made odd, ``BORDER_REPLICATE``); the contrast factor of
  ``compute_k_percentile`` (the 70th percentile of a 300-bin histogram of
  the interior Scharr gradient magnitudes after a sigma 1 smoothing); then
  level by level the Perona-Malik g2 conductivity ``pm_g2`` of the Scharr
  derivatives (``BORDER_DEFAULT``, reflect 101) of the previous level
  smoothed at sigma 1, and the FED cycles of ``fed_tau_by_process_time``
  (tau_max 0.25, kappa reordering) between the evolution times ``0.5
  sigma^2``, ``sigma = 1.6 2^(o + s / 4)``, each step
  ``nld_step_scalar``'s (no flux across the border, the corners fixed).
- The detector (``Feature_Detection``): ``Compute_Multiscale_Derivatives``
  (the Scharr-like kernels of ``compute_derivative_kernels`` at
  ``cvRound(sigma)``, scale-normalised), the Hessian determinant,
  ``FindExtremumKAZEInvoker``'s 3 x 3 x 3 maxima above the threshold,
  ``Determinant_Hessian``'s removal of repeats across neighbouring levels,
  and ``Do_Subpixel_Refinement``'s quadratic fit in (x, y, scale), solved
  as ``cv::solve`` solves a 3 x 3 system (Cramer's rule in double); it
  gives ``pt``, ``size``, ``response``, ``octave`` and ``class_id`` as cv2
  does.
- The description (``Feature_Description``), for keypoints that carry
  their level in ``class_id`` as ``detect`` gives them:
  ``Compute_Main_Orientation`` (Gaussian-weighted, 2.5 s, derivative
  responses within 6 s, angles by ``fastAtan2``, the sliding 60 degree
  window in 0.15 rad steps) and ``Get_KAZE_Descriptor_64`` (M-SURF: 4 x 4
  overlapping 9 x 9 subregions of a 24 s square rotated to the angle,
  bilinear samples, Gaussian weights, L2 normalised). As in ``cv2``'s
  ``compute``, the scale space is built anew for the description and its
  derivatives are the ones the scale space computed (unit Scharr of the
  level's smoothed image), not the detector's.

The scale space's separable filters run as matrix products (each 1-D
pass of a border-padded stack times one banded matrix) inside
``core.device.fp32_strict``: no TF32 on the card. Everything after the
candidates is per keypoint; the one sequential step, the removal of
repeats, runs on the host.

Where ``cv2.KAZE_create`` exists (opencv 4.x; not opencv-python 5.0) the
port is held against it: ``tests/test_torch_kaze_oracle.py``.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.device import fp32_strict

_F = np.float32
SOFFSET = _F(1.6)
SDERIVATIVES = _F(1.0)
N_OCTAVES = 4
N_SUBLEVELS = 4
THRESHOLD = _F(0.001)
KCONTRAST_PERCENTILE = _F(0.7)
KCONTRAST_BINS = 300
# compute_k_percentile's factor when no interior pixel has a gradient
KCONTRAST_FLAT = _F(0.03)
TAU_MAX = _F(0.25)
DESCRIPTOR_SIZE = 64
# Determinant_Hessian drops a point whose descriptor square (3 sizes
# each way, at its level's unrefined size) leaves the image
_DESCRIPTOR_REACH = _F(3.0)
_FLT_DBL_EPSILON = _F(2.220446049250313e-16)
_PI = math.pi


# ------------------------------------------------------------ arithmetic


def cv_round(x):
    """``cvRound``: the nearest integer, halves to even."""
    return np.rint(x).astype(np.int64)


def _kernel_size(sigma: np.float32) -> int:
    """``gaussian_2D_convolution``'s kernel size for ``sigma``."""
    k = int(math.ceil(_F(2.0) * (_F(1.0) + (_F(sigma) - _F(0.8)) / _F(0.3))))
    return k + 1 if k % 2 == 0 else k


def gaussian_kernel(ksize: int, sigma: float) -> np.ndarray:
    """``getGaussianKernel(ksize, sigma, CV_32F)`` (its bit-exact double
    construction, symmetric, normalised to sum 1, cast to float32)."""
    sigma = float(sigma)
    half = (ksize - 1) // 2
    vals = [math.exp((2 * i + 1 - ksize) ** 2 * (-0.125 / (sigma * sigma)))
            for i in range(half)]
    total = 2.0 * sum(vals) + 1.0 + (1.0 if ksize % 2 == 0 else 0.0)
    k = np.empty(ksize, np.float64)
    for i, v in enumerate(vals):
        k[i] = k[ksize - 1 - i] = v * (1.0 / total)
    k[half] = 1.0 / total
    if ksize % 2 == 0:
        k[half + 1] = k[half]
    return k.astype(np.float32)


def derivative_kernels(order_x: int, order_y: int, scale: int
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """``compute_derivative_kernels``: the (x, y) kernels of a first
    derivative or a smoothing along each axis at ``scale``; at scale 1
    the normalised Scharr kernels of ``getDerivKernels``."""
    if scale == 1:
        smooth = np.array([3, 10, 3], np.float64) / 32.0
        deriv = np.array([-1, 0, 1], np.float64)
        return tuple((deriv if o else smooth).astype(np.float32)
                     for o in (order_x, order_y))
    ksize = 3 + 2 * (scale - 1)
    w = _F(10.0) / _F(3.0)
    norm = _F(1.0) / (_F(2.0) * _F(scale) * (w + _F(2.0)))
    out = []
    for o in (order_x, order_y):
        k = np.zeros(ksize, np.float32)
        if o == 0:
            k[0], k[ksize // 2], k[-1] = norm, w * norm, norm
        else:
            k[0], k[-1] = -1.0, 1.0
        out.append(k)
    return out[0], out[1]


def _border_index(n: int, r: int, mode: str) -> np.ndarray:
    """``borderInterpolate`` of positions -r .. n - 1 + r into [0, n):
    "replicate" (BORDER_REPLICATE) or "reflect101" (BORDER_DEFAULT)."""
    p = np.arange(-r, n + r)
    if mode == "replicate":
        return np.clip(p, 0, n - 1)
    if n == 1:
        return np.zeros_like(p)
    out = p.copy()
    for i, v in enumerate(p):
        while not 0 <= v < n:
            v = -v if v < 0 else 2 * (n - 1) - v
        out[i] = v
    return out


@functools.lru_cache(maxsize=256)
def _band_matrix(n: int, k: Tuple[float, ...]) -> np.ndarray:
    """(n + 2r, n) float32 T with ``(xp @ T)[j] = sum_t k[t] xp[j + t]``:
    the 1-D correlation with ``k`` of a row padded by r = len(k) // 2 on
    each side, each tap its own product as in cv2's filters (folding the
    border into the taps would round the border pixels apart)."""
    t = np.zeros((n + len(k) - 1, n), np.float32)
    for j in range(n):
        t[j:j + len(k), j] = k
    return t


def sep_filter(src: torch.Tensor, kx: np.ndarray, ky: np.ndarray,
               border: str) -> torch.Tensor:
    """``sepFilter2D`` (correlation, anchor at the centre) of a (B, H, W)
    float32 stack: ``kx`` along the rows, then ``ky`` along the columns,
    each pass padded by ``border`` and applied as a product with a banded
    matrix (fp32 only inside ``fp32_strict``)."""
    _, h, w = src.shape
    dev = src.device
    rx, ry = len(kx) // 2, len(ky) // 2
    tx = torch.as_tensor(_band_matrix(w, tuple(kx.tolist())), device=dev)
    ty = torch.as_tensor(_band_matrix(h, tuple(ky.tolist())).T, device=dev)
    x = src[..., torch.as_tensor(_border_index(w, rx, border), device=dev)]
    x = torch.matmul(x, tx)
    x = x[..., torch.as_tensor(_border_index(h, ry, border), device=dev), :]
    return torch.matmul(ty, x)


def gaussian_blur(src: torch.Tensor, sigma) -> torch.Tensor:
    """``gaussian_2D_convolution(src, dst, 0, 0, sigma)``."""
    k = gaussian_kernel(_kernel_size(_F(sigma)), float(_F(sigma)))
    return sep_filter(src, k, k, "replicate")


def scharr(src: torch.Tensor, order_x: int, order_y: int) -> torch.Tensor:
    """``Scharr(src, dst, CV_32F, order_x, order_y, 1, 0,
    BORDER_DEFAULT)``: the unnormalised Scharr kernels."""
    smooth = np.array([3, 10, 3], np.float32)
    deriv = np.array([-1, 0, 1], np.float32)
    return sep_filter(src, deriv if order_x else smooth,
                      deriv if order_y else smooth, "reflect101")


def fast_atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``cv::fastAtan2(y, x)``: OpenCV's polynomial atan2, in degrees in
    [0, 360)."""
    p1 = _F(_F(0.9997878412794807) * _F(180 / _PI))
    p3 = _F(_F(-0.3258083974640975) * _F(180 / _PI))
    p5 = _F(_F(0.1555786518463281) * _F(180 / _PI))
    p7 = _F(_F(-0.04432655554792128) * _F(180 / _PI))
    ax, ay = x.abs(), y.abs()
    wide = ax >= ay
    c = torch.where(wide, ay / (ax + _FLT_DBL_EPSILON),
                    ax / (ay + _FLT_DBL_EPSILON))
    c2 = c * c
    a = (((p7 * c2 + p5) * c2 + p3) * c2 + p1) * c
    a = torch.where(wide, a, _F(90.0) - a)
    a = torch.where(x < 0, _F(180.0) - a, a)
    return torch.where(y < 0, _F(360.0) - a, a)


# ------------------------------------------------------------- the levels


@dataclass(frozen=True)
class Level:
    octave: int
    sublevel: int
    esigma: np.float32
    etime: np.float32
    sigma_size: int


def levels() -> List[Level]:
    """``Allocate_Memory_Evolution``'s levels, in float32."""
    out = []
    for o in range(N_OCTAVES):
        for s in range(N_SUBLEVELS):
            esigma = SOFFSET * np.power(_F(2.0), _F(s) / _F(N_SUBLEVELS)
                                        + _F(o))
            out.append(Level(o, s, _F(esigma), _F(_F(0.5) * (esigma * esigma)),
                             int(cv_round(esigma))))
    return out


def _is_prime(n: int) -> bool:
    """``fed_is_prime_internal``."""
    if n <= 1:
        return False
    if n in (2, 3, 5, 7):
        return True
    if n % 2 == 0 or n % 3 == 0 or n % 5 == 0 or n % 7 == 0:
        return False
    limit = int(math.sqrt(_F(1.0) + _F(n)))
    return all(n % d for d in range(11, limit + 1, 2))


def fed_tau(t: np.float32, tau_max: np.float32 = TAU_MAX) -> List[np.float32]:
    """``fed_tau_by_process_time(t, 1, tau_max, true, tau)``: the FED
    cycle's step sizes in float32, in the kappa order."""
    t = _F(t)
    n = int(_F(math.ceil(_F(np.sqrt(_F(_F(3.0) * t / tau_max) + _F(0.25)))
                         - _F(0.5) - _F(1.0e-8))) + _F(0.5))
    if n <= 0:
        return []
    scale = _F(_F(3.0) * t / (tau_max * _F(n * (n + 1))))
    c = _F(_F(1.0) / (_F(4.0) * _F(n) + _F(2.0)))
    d = _F(scale * tau_max / _F(2.0))
    tauh = []
    for k in range(n):
        h = np.cos(_F(_F(_PI) * (_F(2.0) * _F(k) + _F(1.0)) * c))
        tauh.append(_F(d / _F(h * h)))
    kappa, prime = n // 2, n + 1
    while not _is_prime(prime):
        prime += 1
    tau, k = [], 0
    for _ in range(n):
        while ((k + 1) * kappa) % prime - 1 >= n:
            k += 1
        tau.append(tauh[((k + 1) * kappa) % prime - 1])
        k += 1
    return tau


def k_percentile(img: torch.Tensor) -> torch.Tensor:
    """``compute_k_percentile(img, 0.7, 1.0, 300, 0, 0)`` of each image
    of a (B, H, W) stack: (B,) float32."""
    g = gaussian_blur(img, SDERIVATIVES)
    lx, ly = scharr(g, 1, 0), scharr(g, 0, 1)
    modg = torch.sqrt(lx * lx + ly * ly)[:, 1:-1, 1:-1].flatten(1)
    hmax = modg.amax(1, keepdim=True)
    nz = modg != 0
    nbin = torch.floor(_F(KCONTRAST_BINS) * (modg / torch.where(
        hmax > 0, hmax, torch.ones_like(hmax)))).to(torch.int64)
    nbin = nbin.clamp(max=KCONTRAST_BINS - 1)
    hist = torch.zeros(len(img), KCONTRAST_BINS, dtype=torch.int64,
                       device=img.device)
    hist.scatter_add_(1, torch.where(nz, nbin, 0), nz.to(torch.int64))
    npoints = nz.sum(1).to(torch.float32)
    nthreshold = (npoints * KCONTRAST_PERCENTILE).to(torch.int64)
    # the bins summed until the count reaches the threshold
    k = (hist.cumsum(1) < nthreshold[:, None]).sum(1) + \
        (nthreshold > 0).to(torch.int64)
    k = k.clamp(max=KCONTRAST_BINS)
    kperc = hmax[:, 0] * (k.to(torch.float32) / _F(KCONTRAST_BINS))
    return torch.where(hmax[:, 0] > 0, kperc,
                       torch.full_like(kperc, KCONTRAST_FLAT))


def nld_step(lt: torch.Tensor, c: torch.Tensor, tau) -> torch.Tensor:
    """``nld_step_scalar``: one explicit diffusion step of size ``tau``
    with conductivity ``c``, no flux across the border and the four
    corners left as they are."""
    fx = (c[..., :-1] + c[..., 1:]) * (lt[..., 1:] - lt[..., :-1])
    fy = (c[..., :-1, :] + c[..., 1:, :]) * (lt[..., 1:, :] - lt[..., :-1, :])
    xpos, xneg = F.pad(fx, (0, 1)), F.pad(fx, (1, 0))
    ypos, yneg = F.pad(fy, (0, 0, 0, 1)), F.pad(fy, (0, 0, 1, 0))
    step = _F(_F(0.5) * _F(tau)) * (xpos - xneg + ypos - yneg)
    step[..., 0, 0] = 0
    step[..., 0, -1] = 0
    step[..., -1, 0] = 0
    step[..., -1, -1] = 0
    return lt + step


@dataclass
class ScaleSpace:
    """The levels of a (B, H, W) stack: each level's Hessian determinant
    ``ldet`` and the scale space's own derivatives ``lx``, ``ly`` (the
    description's), all (B, L, H, W) float32."""
    ldet: torch.Tensor
    lx: torch.Tensor
    ly: torch.Tensor
    levels: List[Level]


def scale_space(images: torch.Tensor) -> ScaleSpace:
    """``Create_Nonlinear_Scale_Space`` and ``Compute_Detector_Response``
    of a (B, H, W) uint8 stack on its device."""
    lv = levels()
    with fp32_strict():
        lt = images.to(torch.float32) * _F(1.0 / 255.0)
        lt = gaussian_blur(lt, SOFFSET)
        kcontrast = k_percentile(lt)
        k2inv = (_F(1.0) / (kcontrast * kcontrast))[:, None, None]
        lsmooth = gaussian_blur(lt, SDERIVATIVES)
        zeros = torch.zeros_like(lt)
        ldet, lxs, lys = [], [zeros], [zeros]
        for i, level in enumerate(lv):
            if i > 0:
                lsmooth = gaussian_blur(lt, SDERIVATIVES)
                lx, ly = scharr(lsmooth, 1, 0), scharr(lsmooth, 0, 1)
                flow = _F(1.0) / (_F(1.0) + (lx * lx + ly * ly) * k2inv)
                for tau in fed_tau(_F(level.etime - lv[i - 1].etime)):
                    lt = nld_step(lt, flow, tau)
                lxs.append(lx)
                lys.append(ly)
            ldet.append(_hessian_determinant(lsmooth, level.sigma_size))
        return ScaleSpace(torch.stack(ldet, 1), torch.stack(lxs, 1),
                          torch.stack(lys, 1), lv)


def _hessian_determinant(lsmooth: torch.Tensor, s: int) -> torch.Tensor:
    """``Compute_Multiscale_Derivatives`` at ``sigma_size`` s and the
    determinant ``lxx lyy - lxy^2`` of the scale-normalised Hessian."""
    kx1, ky0 = derivative_kernels(1, 0, s)
    kx0, ky1 = derivative_kernels(0, 1, s)
    lx = sep_filter(lsmooth, kx1, ky0, "reflect101")
    ly = sep_filter(lsmooth, kx0, ky1, "reflect101")
    lxx = sep_filter(lx, kx1, ky0, "reflect101") * _F(s * s)
    lyy = sep_filter(ly, kx0, ky1, "reflect101") * _F(s * s)
    lxy = sep_filter(lx, kx0, ky1, "reflect101") * _F(s * s)
    return lxx * lyy - lxy * lxy


# -------------------------------------------------------------- detection


@dataclass
class KeyPoints:
    """One image's keypoints in cv2's fields: ``pt`` (n, 2) float32 (x,
    y), ``size``, ``angle`` (degrees), ``response`` float32, ``octave``,
    ``class_id`` (the level) int."""
    pt: np.ndarray
    size: np.ndarray
    angle: np.ndarray
    response: np.ndarray
    octave: np.ndarray
    class_id: np.ndarray

    def __len__(self) -> int:
        return len(self.size)

    def take(self, idx) -> "KeyPoints":
        return KeyPoints(*(getattr(self, f.name)[idx]
                           for f in dataclasses.fields(self)))


def _candidates(ss: ScaleSpace) -> torch.Tensor:
    """``FindExtremumKAZEInvoker``: (n, 4) (image, level, y, x) of the
    interior pixels of levels 1 .. L - 2 above the threshold that no
    pixel of their 3 x 3 neighbourhood on their level and the two beside
    it exceeds, in (image, level, row, column) order."""
    d = ss.ldet
    b, nl, h, w = d.shape
    m = F.max_pool2d(d.reshape(b * nl, 1, h, w), 3, 1, 1).reshape(b, nl, h, w)
    v = d[:, 1:-1]
    ok = (v > THRESHOLD) & (v >= m[:, 1:-1]) & (v >= m[:, :-2]) & \
        (v >= m[:, 2:])
    ok[..., 0, :] = ok[..., -1, :] = False
    ok[..., :, 0] = ok[..., :, -1] = False
    idx = ok.nonzero()
    idx[:, 1] += 1
    return idx


def _drop_repeats(cand: np.ndarray, resp: np.ndarray, lv: List[Level],
                  h: int, w: int) -> List[int]:
    """``Determinant_Hessian``: candidates in order; one within
    ``sigma_size`` of a kept point of its own or a neighbouring level
    replaces the first such point if stronger, else is dropped, and so is
    one whose descriptor square (``_DESCRIPTOR_REACH`` sizes each way)
    leaves the (h, w) image. Returns the kept candidates' indices in
    keypoint order."""
    kept: List[int] = []
    for i, (level, y, x) in enumerate(cand):
        r2 = lv[level].sigma_size ** 2
        rep, extremum = -1, True
        for slot, j in enumerate(kept):
            lj, yj, xj = cand[j]
            if abs(int(lj) - int(level)) <= 1 and \
                    (x - xj) ** 2 + (y - yj) ** 2 < r2:
                if resp[i] > resp[j]:
                    rep = slot
                else:
                    extremum = False
                break
        reach = _DESCRIPTOR_REACH * lv[level].esigma
        if extremum and (cv_round(_F(x) - reach) < 0
                         or cv_round(_F(x) + reach) >= w
                         or cv_round(_F(y) - reach) < 0
                         or cv_round(_F(y) + reach) >= h):
            extremum = False
        if extremum:
            if rep < 0:
                kept.append(i)
            else:
                kept[rep] = i
    return kept


def _refine(ss: ScaleSpace, img: int, cand: np.ndarray,
            resp: np.ndarray) -> KeyPoints:
    """``Do_Subpixel_Refinement`` of one image's kept candidates (level,
    y, x): the quadratic fit of the determinant over the 3 x 3 x 3
    neighbourhood, kept where every offset is within 1."""
    dev = ss.ldet.device
    lvl, y, x = (torch.as_tensor(cand[:, i], device=dev) for i in range(3))
    off = torch.arange(-1, 2, device=dev)
    nb = ss.ldet[img, (lvl[:, None] + off)[:, :, None, None],
                 (y[:, None] + off)[:, None, :, None],
                 (x[:, None] + off)[:, None, None, :]]
    n = nb.cpu().numpy().astype(np.float32)    # (n, scale, y, x)
    c = n[:, 1, 1, 1]
    dx = _F(0.5) * (n[:, 1, 1, 2] - n[:, 1, 1, 0])
    dy = _F(0.5) * (n[:, 1, 2, 1] - n[:, 1, 0, 1])
    ds = _F(0.5) * (n[:, 2, 1, 1] - n[:, 0, 1, 1])
    dxx = _F(1.0) * (n[:, 1, 1, 2] + n[:, 1, 1, 0] - _F(2.0) * c)
    dyy = _F(1.0) * (n[:, 1, 2, 1] + n[:, 1, 0, 1] - _F(2.0) * c)
    dss = n[:, 2, 1, 1] + n[:, 0, 1, 1] - _F(2.0) * c
    q = _F(0.25)
    dxy = q * (n[:, 1, 2, 2] + n[:, 1, 0, 0]) - q * (n[:, 1, 0, 2]
                                                     + n[:, 1, 2, 0])
    dxs = q * (n[:, 2, 1, 2] + n[:, 0, 1, 0]) - q * (n[:, 2, 1, 0]
                                                     + n[:, 0, 1, 2])
    dys = q * (n[:, 2, 2, 1] + n[:, 0, 0, 1]) - q * (n[:, 2, 0, 1]
                                                     + n[:, 0, 2, 1])
    a = np.stack([np.stack([dxx, dxy, dxs], 1), np.stack([dxy, dyy, dys], 1),
                  np.stack([dxs, dys, dss], 1)], 1)
    sol = _solve3(a, np.stack([-dx, -dy, -ds], 1))
    keep = np.all(np.abs(sol) <= 1.0, 1)
    lv = ss.levels
    octave = np.array([lv[l].octave for l in cand[:, 0]], np.int64)
    sub = np.array([lv[l].sublevel for l in cand[:, 0]], np.float32)
    dsc = octave.astype(np.float32) + (sub + sol[:, 2]) / _F(N_SUBLEVELS)
    size = _F(2.0) * SOFFSET * np.power(_F(2.0), dsc.astype(np.float32))
    pt = np.stack([cand[:, 2].astype(np.float32) + sol[:, 0],
                   cand[:, 1].astype(np.float32) + sol[:, 1]], 1)
    kp = KeyPoints(pt.astype(np.float32), size.astype(np.float32),
                   np.zeros(len(cand), np.float32), resp.astype(np.float32),
                   octave, cand[:, 0].astype(np.int64))
    return kp.take(np.nonzero(keep)[0])


def _solve3(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """``cv::solve(A, b, DECOMP_LU)`` of float32 3 x 3 systems: Cramer's
    rule in double, cast to float32; a singular system gives zeros."""
    a = a.astype(np.float64)
    b = b.astype(np.float64)

    def det3(m):
        return (m[:, 0, 0] * (m[:, 1, 1] * m[:, 2, 2]
                              - m[:, 1, 2] * m[:, 2, 1])
                - m[:, 0, 1] * (m[:, 1, 0] * m[:, 2, 2]
                                - m[:, 1, 2] * m[:, 2, 0])
                + m[:, 0, 2] * (m[:, 1, 0] * m[:, 2, 1]
                                - m[:, 1, 1] * m[:, 2, 0]))
    d = det3(a)
    out = np.zeros_like(b)
    ok = d != 0
    inv = 1.0 / d[ok]
    for i in range(3):
        m = a.copy()
        m[:, :, i] = b
        out[ok, i] = inv * det3(m[ok])
    return out.astype(np.float32)


def detect(ss: ScaleSpace) -> List[KeyPoints]:
    """``Feature_Detection`` of every image of a scale space: keypoints in
    cv2's order."""
    cand = _candidates(ss)
    resp = ss.ldet[cand[:, 0], cand[:, 1], cand[:, 2], cand[:, 3]]
    cand, resp = cand.cpu().numpy(), resp.abs().cpu().numpy()
    out = []
    h, w = ss.ldet.shape[-2:]
    for b in range(ss.ldet.shape[0]):
        rows = np.nonzero(cand[:, 0] == b)[0]
        kept = rows[_drop_repeats(cand[rows, 1:], resp[rows], ss.levels,
                                  h, w)]
        out.append(_refine(ss, b, cand[kept, 1:], resp[kept]))
    return out


# ------------------------------------------------------------ description


def _orientation(ss: ScaleSpace, img: torch.Tensor, kp: KeyPoints
                 ) -> torch.Tensor:
    """``Compute_Main_Orientation``: (n,) angles in degrees."""
    dev = ss.lx.device
    _, _, h, w = ss.lx.shape
    ij = [(i, j) for i in range(-6, 7) for j in range(-6, 7)
          if i * i + j * j < 36]
    oi = torch.tensor([p[0] for p in ij], device=dev)
    oj = torch.tensor([p[1] for p in ij], device=dev)
    xf = torch.as_tensor(kp.pt[:, 0], device=dev)[:, None]
    yf = torch.as_tensor(kp.pt[:, 1], device=dev)[:, None]
    s = torch.as_tensor(cv_round(kp.size / _F(2.0)), device=dev)[:, None]
    lvl = torch.as_tensor(kp.class_id, device=dev)[:, None]
    iy = torch.round(yf + (oj * s).to(torch.float32)).to(torch.int64)
    ix = torch.round(xf + (oi * s).to(torch.float32)).to(torch.int64)
    inside = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
    cy, cx = iy.clamp(0, h - 1), ix.clamp(0, w - 1)
    sig = _F(2.5) * s.to(torch.float32)
    gx, gy = (iy - yf).to(torch.float32), (ix - xf).to(torch.float32)
    gw = torch.exp(-(gx * gx + gy * gy) / (_F(2.0) * sig * sig))
    zero = torch.zeros((), device=dev)
    img = img[:, None]
    res_x = torch.where(inside, gw * ss.lx[img, lvl, cy, cx], zero)
    res_y = torch.where(inside, gw * ss.ly[img, lvl, cy, cx], zero)
    ang = (fast_atan2(res_y, res_x) * _F(_PI / _F(180.0)))[:, None, :]
    # the sliding windows (ang1, ang2), in float32 as the loop steps them
    two_pi, third = _F(2.0 * _PI), _F(_PI / 3.0)
    a1s, a1 = [], _F(0.0)
    while a1 < 2.0 * _PI:
        a1s.append(a1)
        a1 = _F(a1 + _F(0.15))
    a2s = [_F(a - _F(5.0 * _PI / 3.0)) if _F(a + third) > two_pi
           else _F(a + third) for a in a1s]
    a1t = torch.tensor(a1s, device=dev)[None, :, None]
    a2t = torch.tensor(a2s, device=dev)[None, :, None]
    inw = torch.where(a1t < a2t, (a1t < ang) & (ang < a2t),
                      ((ang > 0) & (ang < a2t)) | ((ang > a1t)
                                                   & (ang < two_pi)))
    sx = _ordered_sum(torch.where(inw, res_x[:, None, :], zero))
    sy = _ordered_sum(torch.where(inw, res_y[:, None, :], zero))
    mag = sx * sx + sy * sy
    # the first window of the largest sum, where it is above 0
    best = mag.argmax(1, keepdim=True)
    angle = fast_atan2(sy.gather(1, best), sx.gather(1, best))[:, 0]
    return torch.where(mag.amax(1) > 0, angle, torch.zeros_like(angle))


def _ordered_sum(v: torch.Tensor) -> torch.Tensor:
    """Sums over the last axis, added first to last in float32 as a C
    loop adds them."""
    acc = torch.zeros(v.shape[:-1], dtype=v.dtype, device=v.device)
    for k in range(v.shape[-1]):
        acc = acc + v[..., k]
    return acc


def _descriptor(ss: ScaleSpace, img: torch.Tensor, kp: KeyPoints,
                angle_deg: torch.Tensor) -> torch.Tensor:
    """``Get_KAZE_Descriptor_64``: (n, 64) float32. The 4 x 4 subregions
    (their sample offsets k, l from -12 in steps of 5, 9 x 9 each) are
    evaluated together; each subregion's 81 samples are added in the C
    loop's order."""
    dev = ss.lx.device
    _, _, h, w = ss.lx.shape
    xf = torch.as_tensor(kp.pt[:, 0], device=dev)[:, None, None]
    yf = torch.as_tensor(kp.pt[:, 1], device=dev)[:, None, None]
    scale = torch.as_tensor(cv_round(kp.size / _F(2.0)),
                            device=dev)[:, None, None]
    lvl = torch.as_tensor(kp.class_id, device=dev)[:, None, None]
    img = img[:, None, None]
    ang = angle_deg * _F(_PI / _F(180.0))
    co = torch.cos(ang)[:, None, None]
    si = torch.sin(ang)[:, None, None]
    starts = (-12, -7, -2, 3)
    # (16, 81) offsets: subregion (i, j) row-major, samples k outer, l inner
    kk = torch.tensor([[k for k in range(i, i + 9) for _ in range(9)]
                       for i in starts for _ in starts], device=dev)
    ll = torch.tensor([[l for _ in range(9) for l in range(j, j + 9)]
                       for _ in starts for j in starts], device=dev)
    ky = torch.tensor([i + 5 for i in starts for _ in starts],
                      device=dev)[:, None]
    kx = torch.tensor([j + 5 for _ in starts for j in starts],
                      device=dev)[:, None]
    xs = xf + ((-kx * scale).float() * si + (ky * scale).float() * co)
    ys = yf + ((kx * scale).float() * co + (ky * scale).float() * si)
    sy = yf + ((ll * scale).float() * co + (kk * scale).float() * si)
    sx = xf + ((-ll * scale).float() * si + (kk * scale).float() * co)
    ex, ey = xs - sx, ys - sy
    sig1 = _F(2.5) * scale.float()
    g1 = torch.exp(-(ex * ex + ey * ey) / (_F(2.0) * sig1 * sig1))
    # the corner below: floored, clamped to the image, its neighbour one
    # on and clamped again, the fractions taken from the clamped corner
    # (so a sample outside the image extrapolates the border's two rows)
    y1 = torch.floor(sy).to(torch.int64).clamp(0, h - 1)
    x1 = torch.floor(sx).to(torch.int64).clamp(0, w - 1)
    y2, x2 = (y1 + 1).clamp(0, h - 1), (x1 + 1).clamp(0, w - 1)
    fx, fy = sx - x1.float(), sy - y1.float()
    rx = _bilinear(ss.lx, img, lvl, x1, y1, x2, y2, fx, fy)
    ry = _bilinear(ss.ly, img, lvl, x1, y1, x2, y2, fx, fy)
    rry = g1 * (rx * co + ry * si)
    rrx = g1 * (-rx * si + ry * co)
    dx, dy = _ordered_sum(rrx), _ordered_sum(rry)
    mdx, mdy = _ordered_sum(rrx.abs()), _ordered_sum(rry.abs())
    cs = np.arange(4, dtype=np.float32) + _F(0.5)
    g2 = torch.tensor(
        [np.exp(_F(-(_F(cx - 2) * _F(cx - 2) + _F(cy - 2) * _F(cy - 2))
                   / _F(2.0 * 1.5 * 1.5))) for cx in cs for cy in cs],
        dtype=torch.float32, device=dev)
    desc = torch.stack([dx * g2, dy * g2, mdx * g2, mdy * g2], 2)
    terms = (dx * dx + dy * dy + mdx * mdx + mdy * mdy) * g2 * g2
    return desc.flatten(1) / torch.sqrt(_ordered_sum(terms))[:, None]


def _bilinear(field, img, lvl, x1, y1, x2, y2, fx, fy):
    """``Get_KAZE_Descriptor_64``'s bilinear sample, in its order."""
    r1 = field[img, lvl, y1, x1]
    r2 = field[img, lvl, y1, x2]
    r3 = field[img, lvl, y2, x1]
    r4 = field[img, lvl, y2, x2]
    one = _F(1.0)
    return (one - fx) * (one - fy) * r1 + fx * (one - fy) * r2 + \
        (one - fx) * fy * r3 + fx * fy * r4


def describe(ss: ScaleSpace, keypoints: Sequence[KeyPoints]
             ) -> List[Tuple[KeyPoints, np.ndarray]]:
    """``Feature_Description`` of each image's keypoints (as ``detect``
    gives them, or a selection): the keypoints with their main
    orientation in ``angle`` (degrees) and their (n, 64) float32
    descriptors."""
    counts = [len(k) for k in keypoints]
    if sum(counts) == 0:
        return [(k, np.zeros((0, DESCRIPTOR_SIZE), np.float32))
                for k in keypoints]
    dev = ss.lx.device
    allk = KeyPoints(*(np.concatenate([getattr(k, f.name) for k in keypoints])
                       for f in dataclasses.fields(KeyPoints)))
    img = torch.as_tensor(np.repeat(np.arange(len(keypoints)), counts),
                          device=dev)
    with fp32_strict():
        angle = _orientation(ss, img, allk)
        desc = _descriptor(ss, img, allk, angle).cpu().numpy()
    angle = angle.cpu().numpy().astype(np.float32)
    out, start = [], 0
    for k, c in zip(keypoints, counts):
        sel = slice(start, start + c)
        kk = KeyPoints(k.pt, k.size, angle[sel], k.response, k.octave,
                       k.class_id)
        out.append((kk, desc[sel].astype(np.float32)))
        start += c
    return out


def detect_and_compute(images: torch.Tensor, top: Optional[int] = None
                       ) -> List[Tuple[KeyPoints, np.ndarray]]:
    """``detect`` then ``compute`` on a (B, H, W) uint8 stack (on the
    device it lies on), as ``KAZE_create()`` does them one image at a
    time. ``top`` keeps each image's ``top`` strongest keypoints (a
    stable sort by descending response) before the description."""
    if images.dim() != 3 or images.dtype != torch.uint8:
        raise ValueError(f"KAZE takes a (B, H, W) uint8 stack, not "
                         f"{tuple(images.shape)} {images.dtype}")
    ss = scale_space(images)
    kps = detect(ss)
    if top is not None:
        kps = [k.take(np.argsort(-k.response, kind="stable")[:top])
               for k in kps]
    return describe(ss, kps)
