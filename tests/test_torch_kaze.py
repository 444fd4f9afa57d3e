"""``analysis/kaze.py`` and ``analysis.morphology.extract_features`` on
the CPU. This machine's opencv-python 5.0 has no ``KAZE_create``, so the
whole detector is held to OpenCV's KAZE on the card's machine
(``tests/test_torch_kaze_oracle.py``); here:

- its pieces against the cv2 functions they mirror, which cv2 5.0 still
  has: ``getGaussianKernel``, ``borderInterpolate``, ``GaussianBlur``
  (BORDER_REPLICATE), ``Scharr`` and ``sepFilter2D`` (BORDER_DEFAULT),
  ``fastAtan2``; and the FED cycle's steps, which sum to its time;
- invariants: planted blobs are found at their centres with sizes that
  grow with the blob's sigma; a 90 degree rotation and a transpose move
  the keypoints with the image (``ROT_*`` and ``T_*`` below); doubling an
  image (which leaves every gradient's order) scales each response by 4
  and leaves everything else bit for bit; repeats are bit-equal;
- ``extract_features``' contract: (C, vector_size * 64) rows, float32
  when every slice fills its row and float64 when the padding's zeros
  promote them, a flat slice all zeros, the ``astype("uint8")``
  wrap-around, and ``Error: ...`` printed with None returned on a bad
  input, as the JAX function returns None here.
"""
import math

import cv2
import numpy as np
import pytest
import torch

from dynamorph_tpu.analysis import morphology as jax_morph
from dynamorph_tpu_torch.analysis import kaze
from dynamorph_tpu_torch.analysis.morphology import extract_features
from test_torch_train import _few_threads  # noqa: F401

FILTER_RTOL = 1e-6          # of the filtered image's largest value
# the invariants' limits (measured values in the comments of each test)
MOVE_PX = 0.1
ANGLE_TOL = 0.1
AGREE_MIN = 0.6
ROT_DESC_MEDIAN = 0.05
T_DESC_MEDIAN = 0.25


def _ellipses(seed, n=5, size=128):
    """Anisotropic blobs, so each keypoint has an orientation (a round
    blob's is a tie between windows)."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:size, :size].astype(float)
    img = np.full((size, size), 25.0)
    for _ in range(n):
        cy, cx = rng.uniform(24, size - 24, 2)
        a, b = rng.uniform(4, 7), rng.uniform(1.5, 2.5)
        t = rng.uniform(0, np.pi)
        u = (xx - cx) * np.cos(t) + (yy - cy) * np.sin(t)
        v = -(xx - cx) * np.sin(t) + (yy - cy) * np.cos(t)
        img += 90 * np.exp(-(u * u / (2 * a * a) + v * v / (2 * b * b)))
    return np.clip(img, 0, 127).astype(np.uint8)


def _run(images):
    return kaze.detect_and_compute(torch.from_numpy(np.stack(images)))


def _nearest(kp, points):
    """For each (x, y) in ``points``: the index of ``kp``'s nearest
    keypoint and its distance."""
    d = np.hypot(kp.pt[None, :, 0] - points[:, None, 0],
                 kp.pt[None, :, 1] - points[:, None, 1])
    j = d.argmin(1)
    return j, d[np.arange(len(points)), j]


def _angle_gap(a_deg, b_deg):
    d = np.deg2rad((np.asarray(a_deg, np.float64) - b_deg) % 360.0)
    return np.minimum(d, 2 * np.pi - d)


# ---------------------------------------------------------------- pieces


@pytest.mark.parametrize("sigma", [1.0, 1.6])
def test_gaussian_kernel_and_blur_are_cv2s(sigma):
    ksize = kaze._kernel_size(np.float32(sigma))
    assert ksize == {1.0: 5, 1.6: 9}[sigma]
    np.testing.assert_allclose(
        kaze.gaussian_kernel(ksize, float(np.float32(sigma))),
        cv2.getGaussianKernel(ksize, float(np.float32(sigma)),
                              cv2.CV_32F)[:, 0], rtol=1e-6)
    img = np.random.RandomState(1).rand(37, 50).astype(np.float32)
    want = cv2.GaussianBlur(img, (ksize, ksize), float(np.float32(sigma)),
                            borderType=cv2.BORDER_REPLICATE)
    got = kaze.gaussian_blur(torch.from_numpy(img)[None], sigma)[0].numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=FILTER_RTOL * np.abs(want).max())


@pytest.mark.parametrize("order", [(1, 0), (0, 1)])
def test_scharr_and_scaled_derivatives_are_cv2s(order):
    img = np.random.RandomState(2).rand(40, 33).astype(np.float32)
    want = cv2.Scharr(img, cv2.CV_32F, *order, scale=1, delta=0,
                      borderType=cv2.BORDER_DEFAULT)
    got = kaze.scharr(torch.from_numpy(img)[None], *order)[0].numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=FILTER_RTOL * np.abs(want).max())
    for s in (2, 5, 22):
        kx, ky = kaze.derivative_kernels(*order, s)
        want = cv2.sepFilter2D(img, cv2.CV_32F, kx, ky,
                               borderType=cv2.BORDER_DEFAULT)
        got = kaze.sep_filter(torch.from_numpy(img)[None], kx, ky,
                              "reflect101")[0].numpy()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=FILTER_RTOL * np.abs(want).max())


def test_border_index_fast_atan2_and_fed_steps():
    for n, r in ((7, 3), (5, 22), (1, 2)):
        for mode, flag in (("replicate", cv2.BORDER_REPLICATE),
                           ("reflect101", cv2.BORDER_REFLECT_101)):
            want = [cv2.borderInterpolate(p, n, flag)
                    for p in range(-r, n + r)]
            assert kaze._border_index(n, r, mode).tolist() == want
    rng = np.random.RandomState(3)
    y, x = rng.randn(2, 500).astype(np.float32)
    y[:4], x[:4] = [0, 1, 0, -1], [1, 0, -1, 0]
    got = kaze.fast_atan2(torch.from_numpy(y), torch.from_numpy(x)).numpy()
    want = np.array([cv2.fastAtan2(float(a), float(b))
                     for a, b in zip(y, x)], np.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    lv = kaze.levels()
    assert [l.sigma_size for l in lv] == \
        [2, 2, 2, 3, 3, 4, 5, 5, 6, 8, 9, 11, 13, 15, 18, 22]
    for a, b in zip(lv, lv[1:]):
        t = b.etime - a.etime
        tau = kaze.fed_tau(t)
        assert len(tau) >= 3
        assert math.isclose(sum(float(v) for v in tau), float(t),
                            rel_tol=1e-5)


# ------------------------------------------------------------ invariants


def test_planted_blobs_are_found_at_their_centres_and_scales():
    """Four blobs of growing sigma, far apart: the strongest keypoint
    near each centre lies within 0.5 px of it (measured 0.01), and the
    sizes grow with sigma."""
    yy, xx = np.mgrid[:160, :160].astype(float)
    centres = [(40.0, 40.0), (40.0, 115.0), (115.0, 40.0), (115.0, 115.0)]
    sigmas = [2.0, 3.0, 4.5, 6.5]
    img = np.full((160, 160), 20.0)
    for (cx, cy), s in zip(centres, sigmas):
        img += 180 * np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * s * s))
    (kp, desc), = _run([img.astype(np.uint8)])
    sizes = []
    for c in centres:
        near = np.hypot(kp.pt[:, 0] - c[0], kp.pt[:, 1] - c[1]) < 3
        assert near.any(), c
        j = np.flatnonzero(near)[np.argmax(kp.response[near])]
        assert np.hypot(*(kp.pt[j] - c)) <= 0.5
        sizes.append(float(kp.size[j]))
    assert sizes == sorted(sizes) and sizes[-1] > 2 * sizes[0], sizes
    np.testing.assert_allclose(np.linalg.norm(desc, axis=1), 1, rtol=1e-5)


@pytest.mark.parametrize("seed", range(2))
def test_rotation_and_transpose_move_the_keypoints(seed):
    """``np.rot90`` and ``.T`` of a scene of ellipses: every keypoint moves
    with the image within MOVE_PX (measured 7.4e-2 at most, most 1e-5);
    at least AGREE_MIN of them turn by -90 degrees (rotation) or reflect
    to 90 - angle (transpose) within ANGLE_TOL (measured 0.69-0.77: the
    rest differ by about pi, where an ellipse's two sides tie, or by a
    step of the 0.15 rad window, which a quarter turn does not map onto
    itself); and where the angles agree the descriptors agree, rotated
    within a median ROT_DESC_MEDIAN (measured 0.017-0.035), and mirrored
    (subregion columns reversed, the first component negated) within
    T_DESC_MEDIAN (measured 0.13-0.18: the 4 x 4 grid of offsets from -12
    in steps of 5 is not symmetric about the point)."""
    img = _ellipses(seed)
    w = img.shape[1]
    (k0, d0), (kr, dr), (kt, dt) = _run([img, np.rot90(img).copy(),
                                         img.T.copy()])
    assert len(k0) == len(kr) == len(kt) > 5
    cases = (
        (kr, dr, np.stack([k0.pt[:, 1], w - 1 - k0.pt[:, 0]], 1),
         k0.angle - 90.0, lambda d: d, ROT_DESC_MEDIAN),
        (kt, dt, k0.pt[:, ::-1], 90.0 - k0.angle,
         lambda d: d.reshape(-1, 4, 4, 4)[:, :, ::-1].reshape(-1, 64)
         * np.tile([-1, 1, 1, 1], 16), T_DESC_MEDIAN))
    for kb, db, moved, turned, mirror, desc_limit in cases:
        j, dist = _nearest(kb, moved)
        assert dist.max() <= MOVE_PX
        agree = _angle_gap(kb.angle[j], turned) <= ANGLE_TOL
        assert agree.mean() >= AGREE_MIN
        err = np.linalg.norm(mirror(d0)[agree] - db[j[agree]], axis=1)
        assert np.median(err) <= desc_limit


def test_doubling_the_image_scales_the_responses_only():
    """Every value of ``2 img`` is exact, so its scale space is twice
    ``img``'s bit for bit (the contrast factor doubles with it): the same
    keypoints at 4x the response, the same descriptors; responses that
    now clear the threshold may add keypoints."""
    img = _ellipses(5)
    assert img.max() <= 127
    (k1, d1), (k2, d2) = _run([img, img * 2])
    j, dist = _nearest(k2, k1.pt)
    assert dist.max() == 0 and len(set(j.tolist())) == len(k1)
    np.testing.assert_array_equal(k2.size[j], k1.size)
    np.testing.assert_array_equal(k2.angle[j], k1.angle)
    np.testing.assert_array_equal(k2.response[j], 4 * k1.response)
    np.testing.assert_array_equal(d2[j], d1)


def test_repeats_are_bit_equal():
    img = _ellipses(7)
    (ka, da), = _run([img])
    (kb, db), = _run([img])
    for f in ("pt", "size", "angle", "response", "octave", "class_id"):
        np.testing.assert_array_equal(getattr(ka, f), getattr(kb, f))
    np.testing.assert_array_equal(da, db)


# ------------------------------------------------------ extract_features


def test_extract_features_contract(capsys):
    """Rows of vector_size * 64; float32 when every slice fills its row,
    float64 when one is padded (a flat slice: all zeros); the uint8
    wrap-around of the input; the strongest keypoints' descriptors in
    order of response."""
    img = _ellipses(3).astype(np.float64)
    full = extract_features(np.stack([img, img + 256.0]), vector_size=4,
                            device="cpu")
    assert full.shape == (2, 256) and full.dtype == np.float32
    np.testing.assert_array_equal(full[0], full[1])
    (kp, desc), = _run([img.astype(np.uint8)])
    order = np.argsort(-kp.response, kind="stable")[:4]
    np.testing.assert_array_equal(full[0], desc[order].reshape(-1))
    mixed = extract_features(np.stack([img, np.full_like(img, 77.0)]),
                             device="cpu")
    assert mixed.shape == (2, 32 * 64) and mixed.dtype == np.float64
    assert not mixed[1].any()
    n = min(len(kp), 32)
    np.testing.assert_array_equal(
        mixed[0, :n * 64],
        desc[np.argsort(-kp.response, kind="stable")[:n]].reshape(-1))
    assert not mixed[0, n * 64:].any()
    assert capsys.readouterr().out == ""


def test_extract_features_prints_the_error_and_returns_none(capsys):
    """A stack of 1-D slices: the port prints ``Error: ...`` and returns
    None; the JAX function returns None too (here because this cv2 has no
    KAZE)."""
    bad = np.zeros((3, 40))
    assert extract_features(bad, device="cpu") is None
    assert capsys.readouterr().out.startswith("Error: ")
    assert jax_morph.extract_features(bad) is None
    assert capsys.readouterr().out.startswith("Error: ")
