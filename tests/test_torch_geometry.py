"""The port's cv2-free geometry (``ops/geometry.py``, ``native/contours``,
``io/png.py::read_png``) against the installed cv2, and the rotating patch
sampler (``seg/data.py``) against the JAX package's, on the CPU. Numpy,
cv2 and torch only: nothing here compiles a JAX program.

Tolerances: float64 warps within 1e-9 of the largest magnitude, float32
within 1e-5 relative; 8- and 16-bit warps equal except at pixels whose
float64 value lies within 1e-6 of a rounding tie (counted, at most 1 in
1000); contours equal point for point in cv2's order, areas and upright
boxes exact, minimum-area rectangles within 1e-4 (the angle in degrees),
the ``w < h`` decision equal except where |w - h| < 1e-4.
"""
import cv2
import numpy as np
import pytest
import torch

from dynamorph_tpu.seg import data as jax_data
from dynamorph_tpu_torch.io.png import read_png, write_png
from dynamorph_tpu_torch.native.contours import (bounding_rect, contour_area,
                                                 find_contours, min_area_rect)
from dynamorph_tpu_torch.ops.geometry import (channel_first, flip, resize,
                                              rotation_matrix_2d, warp_affine,
                                              warp_image)
from dynamorph_tpu_torch.seg import data as port_data
from test_torch_train import _few_threads  # noqa: F401

DTYPES = [np.float64, np.float32, np.uint16, np.uint8]
# (source h, w, channels, angle, centre offset, output (w, h) or "bound")
WARP_CASES = [
    (60, 37, 1, 123.4, (0.3, -0.2), None),
    (77, 91, 2, 33.7, (0.0, 0.0), "bound"),
    (50, 64, 3, -12.5, (1.7, 2.9), (70, 45)),
    (181, 181, 2, 271.3, (0.0, 0.0), None),
    (33, 48, 4, 90.0, (0.5, 0.5), "bound"),
]


def _image(dtype, shape, seed):
    r = np.random.RandomState(seed)
    if dtype in (np.float32, np.float64):
        return (r.rand(*shape) * 1000).astype(dtype)
    return r.randint(0, np.iinfo(dtype).max + 1, shape).astype(dtype)


def _case_matrix(h, w, angle, off, out):
    centre = (w / 2 + off[0], h / 2 + off[1])
    M = cv2.getRotationMatrix2D(centre, angle, 1.0)
    if out == "bound":                    # rotate_image / rotate_bound sizes
        c, s = abs(M[0, 0]), abs(M[0, 1])
        bw, bh = int(h * s + w * c), int(h * c + w * s)
        M[0, 2] += bw / 2 - centre[0]
        M[1, 2] += bh / 2 - centre[1]
        return M, (bw, bh)
    return M, out or (w, h)


def _float64_value(img, M, dsize):
    """The warp in float64 from float coordinates, to find rounding ties."""
    inv = cv2.invertAffineTransform(M)
    w, h = dsize
    xs, ys = np.meshgrid(np.arange(w), np.arange(h))
    sx = inv[0, 0] * xs + inv[0, 1] * ys + inv[0, 2]
    sy = inv[1, 0] * xs + inv[1, 1] * ys + inv[1, 2]
    ix, iy = np.floor(sx).astype(int), np.floor(sy).astype(int)
    a, b = sx - ix, sy - iy
    src = img.astype(np.float64).reshape(img.shape[0], img.shape[1], -1)
    pad = np.pad(src, ((2, 2), (2, 2), (0, 0)))

    def tap(dy, dx):
        yy = np.clip(iy + dy, -2, img.shape[0]) + 2
        xx = np.clip(ix + dx, -2, img.shape[1]) + 2
        return pad[yy, xx]

    a, b = a[..., None], b[..., None]
    v = (tap(0, 0) * (1 - a) + tap(0, 1) * a) * (1 - b) + \
        (tap(1, 0) * (1 - a) + tap(1, 1) * a) * b
    return v.reshape(np.shape(cv2.warpAffine(img, M, dsize)))


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d.__name__)
@pytest.mark.parametrize("case", range(len(WARP_CASES)))
def test_warp_affine_matches_cv2(dtype, case):
    h, w, cn, angle, off, out = WARP_CASES[case]
    img = _image(dtype, (h, w) if cn == 1 else (h, w, cn), case)
    M, dsize = _case_matrix(h, w, angle, off, out)
    want = cv2.warpAffine(img, M, dsize)
    got = warp_image(img, M, dsize)
    assert got.dtype == want.dtype and got.shape == want.shape
    if dtype == np.float64:
        assert np.abs(got - want).max() <= 1e-9 * np.abs(want).max()
    elif dtype == np.float32:
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())
    else:
        diff = got != want
        v = _float64_value(img, M, dsize)
        tie = np.abs(v - np.floor(v) - 0.5) < 1e-6
        assert not (diff & ~tie).any()
        assert diff.sum() <= diff.size // 1000
    # border pixels (taps partly outside the source) are in the check
    assert (want != 0).any() and (want == 0).any()


def test_warp_affine_batched_list_matches_single(monkeypatch):
    """One call on a list of batches (the long-axis extraction's masks and
    windows), in chunks of 2, equals each image warped on its own."""
    from dynamorph_tpu_torch.ops import geometry

    monkeypatch.setattr(geometry, "_CHUNK", 2)
    r = np.random.RandomState(3)
    masks = (r.rand(3, 40, 40, 1) > 0.5).astype(np.uint8)
    wins = r.randint(0, 65536, (3, 40, 40, 2)).astype(np.uint16)
    Ms = np.stack([cv2.getRotationMatrix2D((20.0, 20.0), a, 1)
                   for a in (10.0, -80.0, 45.5)])
    got = warp_affine([torch.from_numpy(masks), torch.from_numpy(wins)], Ms,
                      (40, 40))
    for i in range(3):
        np.testing.assert_array_equal(got[0][i, ..., 0].numpy(),
                                      cv2.warpAffine(masks[i, ..., 0], Ms[i],
                                                     (40, 40)))
        np.testing.assert_array_equal(got[1][i].numpy(),
                                      cv2.warpAffine(wins[i], Ms[i],
                                                     (40, 40)))


@pytest.mark.parametrize("angle", [0.0, 33.7, -90.0, 181.25])
def test_rotation_matrix_matches_cv2(angle):
    for centre in [(10.0, 20.5), (181.5, 181.5), (13.3, 7.7)]:
        np.testing.assert_array_equal(
            rotation_matrix_2d(centre, angle, 1.0),
            cv2.getRotationMatrix2D(centre, angle, 1.0))


def test_flip_and_channel_first_match_cv2():
    r = np.random.RandomState(4)
    mat = r.rand(3, 2, 9, 11)
    np.testing.assert_array_equal(
        channel_first(flip, mat, 1),
        jax_data.cv2_fn_wrapper(cv2.flip, mat, 1))
    t = channel_first(flip, torch.from_numpy(mat), 1)
    np.testing.assert_array_equal(t.numpy(), mat[..., ::-1])


def _masks(kind, seed):
    r = np.random.RandomState(seed)
    h, w = r.randint(20, 70, 2)
    yy, xx = np.mgrid[:h, :w]
    m = np.zeros((h, w), np.uint8)
    if kind == "noise":
        return (r.rand(h, w) > 0.55).astype(np.uint8)
    if kind == "lines":
        m[h // 2, :] = 1
        m[:, w // 3] = 1
        m[2:h - 2, w - 3] = 1
        m[0, 0] = m[h - 1, w - 1] = 1
        return m
    for _ in range(r.randint(2, 5)):
        cy, cx = r.rand(2) * [h, w]
        a, b = r.rand(2) * 12 + 2
        if kind == "near_square":
            b = a * (1 + 1e-3 * r.rand())
        t = r.rand() * np.pi
        u = (xx - cx) * np.cos(t) + (yy - cy) * np.sin(t)
        v = -(xx - cx) * np.sin(t) + (yy - cy) * np.cos(t)
        d = (u / a) ** 2 + (v / b) ** 2
        m |= d < 1
        if kind == "holes":
            m &= ~((d < 0.25) | ((d > 0.5) & (d < 0.6)))
    if kind == "edge":
        m[:, :3] = 1
        m[-2:, :] = 1
    return m


@pytest.mark.parametrize("kind", ["blobs", "holes", "edge", "lines",
                                  "near_square", "noise"])
def test_contours_match_cv2(kind):
    n_rects = 0
    for seed in range(12):
        mask = _masks(kind, seed)
        want = cv2.findContours(mask, 1, 2)[0]
        got = find_contours(mask)
        assert len(got) == len(want)
        for g, c in zip(got, want):
            np.testing.assert_array_equal(g, c[:, 0])
            assert contour_area(g) == cv2.contourArea(c)
            assert bounding_rect(g) == tuple(cv2.boundingRect(c))
            (cx, cy), (rw, rh), ang = min_area_rect(g)
            (wx, wy), (ww, wh), wang = cv2.minAreaRect(c)
            np.testing.assert_allclose([cx, cy, rw, rh], [wx, wy, ww, wh],
                                       atol=1e-4)
            assert abs(ang - wang) <= 1e-4
            if abs(ww - wh) >= 1e-4:
                assert (rw < rh) == (ww < wh)
            n_rects += 1
    assert n_rects >= 12


@pytest.mark.parametrize("angle", [17.0, 123.4, 300.9])
def test_rotate_image_matches_jax(angle):
    r = np.random.RandomState(5)
    mat = r.rand(3, 1, 57, 64) * 65535
    got = port_data.rotate_image(mat, angle)
    want = jax_data.rotate_image(mat, angle)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-9 * np.abs(want).max()


def _sampler_inputs():
    r = np.random.RandomState(6)
    inp = r.randint(0, 65535, (3, 2, 1, 120, 110)).astype(np.uint16)
    prob = r.rand(3, 3, 1, 120, 110)
    ann = r.randint(0, 4, (3, 1, 1, 120, 110))
    ann[1] = 0                      # a frame with one label value
    return inp, prob, ann


@pytest.mark.parametrize("label_input", ["prob", "annotation"])
@pytest.mark.parametrize("rotate", [True, False])
def test_generate_patches_matches_jax(label_input, rotate):
    inp, prob, ann = _sampler_inputs()
    lab = prob if label_input == "prob" else ann
    kw = dict(label_input=label_input, n_patches=5, x_size=32, y_size=32,
              rotate=rotate, mirror=True, seed=3)
    want = jax_data.generate_patches(inp, lab, **kw)
    tail_j = np.random.rand()
    got = port_data.generate_patches(inp, lab, **kw)
    assert np.random.rand() == tail_j       # the same draws from np.random
    assert len(got) == len(want) == 5
    for (x, y), (xj, yj) in zip(got, want):
        assert x.dtype == xj.dtype and y.dtype == yj.dtype
        assert x.shape == xj.shape == (2, 1, 32, 32)
        assert np.abs(x - xj).max() <= 1e-9 * max(np.abs(xj).max(), 1)
        assert np.abs(y - yj).max() <= 1e-9 * max(np.abs(yj).max(), 1)


@pytest.mark.parametrize("time_slices", [1, 2])
def test_generate_ordered_patches_matches_jax(time_slices):
    inp, prob, ann = _sampler_inputs()
    for lab, kind in ((prob, "prob"), (ann, "annotation")):
        kw = dict(label_input=kind, x_size=32, y_size=32,
                  time_slices=time_slices)
        want = jax_data.generate_ordered_patches(inp, lab, **kw)
        got = port_data.generate_ordered_patches(inp, lab, **kw)
        assert len(got) == len(want) > 0
        for (x, y), (xj, yj) in zip(got, want):
            assert x.dtype == xj.dtype and y.dtype == yj.dtype
            np.testing.assert_array_equal(x, xj)
            np.testing.assert_array_equal(y, yj)


def test_load_label_matches_jax(tmp_path):
    import h5py

    lab = np.random.RandomState(7).randint(0, 4, (2, 1, 1, 8, 8))
    np.save(tmp_path / "l.npy", lab)
    with h5py.File(tmp_path / "l.h5", "w") as f:
        f.create_dataset("labels", data=lab)
    for name in ("l.npy", "l.h5"):
        np.testing.assert_array_equal(
            port_data.load_label(str(tmp_path / name)),
            jax_data.load_label(str(tmp_path / name)))


# (dtype, source (h, w), output (w, h)): the validation overlay's 2048 ->
# 1108 (uint8), the GIF's 128 -> 512 and 2048 -> 512 (uint16), and
# non-integer factors up and down for both
RESIZE_CASES = [
    (np.uint8, (2048, 2048), (1108, 1108)),
    (np.uint8, (200, 300), (163, 111)),
    (np.uint8, (37, 50), (131, 97)),
    (np.uint16, (128, 128), (512, 512)),
    (np.uint16, (2048, 2048), (512, 512)),
    (np.uint16, (200, 300), (163, 111)),
    (np.uint16, (37, 50), (131, 97)),
]


@pytest.mark.parametrize("case", range(len(RESIZE_CASES)))
def test_resize_matches_cv2(case):
    dtype, shape, dsize = RESIZE_CASES[case]
    img = _image(dtype, shape, case)
    for interp, flag in (("linear", cv2.INTER_LINEAR),
                         ("nearest", cv2.INTER_NEAREST)):
        np.testing.assert_array_equal(
            resize(img, dsize, interp),
            cv2.resize(img, dsize, interpolation=flag))


@pytest.mark.parametrize("kind", ["gray", "bgr", "bgra", "smooth_bgr"])
@pytest.mark.parametrize("writer", ["cv2", "port"])
def test_read_png_matches_cv2(kind, writer, tmp_path):
    """``read_png`` in its two modes against ``cv2.imread``'s flags, on
    files cv2 writes (libpng's adaptive filters) and the port writes."""
    r = np.random.RandomState(8)
    yy, xx = np.mgrid[:50, :60]
    image = {
        "gray": r.randint(0, 256, (37, 53)).astype(np.uint8),
        "bgr": r.randint(0, 256, (40, 33, 3)).astype(np.uint8),
        "bgra": r.randint(0, 256, (21, 19, 4)).astype(np.uint8),
        "smooth_bgr": np.stack([(xx + yy) * k % 256 for k in (1, 2, 3)],
                               -1).astype(np.uint8),
    }[kind]
    path = str(tmp_path / "x.png")
    (cv2.imwrite if writer == "cv2" else write_png)(path, image)
    for mode, flag in (("color", cv2.IMREAD_COLOR),
                       ("gray", cv2.IMREAD_GRAYSCALE)):
        np.testing.assert_array_equal(read_png(path, mode),
                                      cv2.imread(path, flag))
