"""Drawing on numpy images without cv2 or matplotlib: cv2's thick lines
and rectangles bit for bit, matplotlib's colour maps as lookup tables, and
the small primitives of the port's figures (``analysis/plots.py``).

cv2's lines of thickness 2 or more (``cv2.line``, ``cv2.rectangle``; the
default LINE_8) are polygons in 16-bit fixed point: each segment is a
quadrilateral of the line's width, filled by ``FillConvexPoly`` (its edges
traced by ``Line2``, clipped by ``clipLine``), and its end points are
filled circles of half the width (``Circle``), so consecutive segments
join round. ``thick_line`` and ``rectangle`` follow those routines of
OpenCV's ``drawing.cpp`` step for step, with C's integer arithmetic
(truncating division, arithmetic shifts) and ``cvRound``'s round half to
even, and equal the installed cv2 5.0 on the tests' inputs
(``tests/test_torch_plots.py``). Thinner lines (cv2's Bresenham iterator)
are not ported.

The colour maps are matplotlib's, copied as 8-bit tables: the colours
``Colormap(values, bytes=True)`` gives.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT
_DBL_EPSILON = 2.220446049250313e-16

# matplotlib's colour maps, Colormap(np.arange(N), bytes=True)[:, :3],
# as hex (3 bytes a colour): the listed maps with their N colours, the
# continuous ones at their N = 256.
_LUT_HEX = {
    "tab10": (
        "1f77b4ff7f0e2ca02cd627289467bd8c564be377c27f7f7fbcbd2217becf"),
    "Paired": (
        "a6cee31f78b4b2df8a33a02cfb9a99e31a1cfdbf6fff7f00cab2d66a3d9affff99"
        "b15928"),
    "viridis": (
        "44015444025544035745055845065a45085b46095c460b5e460c5f460e61470f62"
        "47116347126547146647156747166947186a48196b481a6c481c6e481d6f481e70"
        "482071482172482273482374472575472676472777472878472a79472b7a472c7b"
        "462d7c462f7c46307d46317e45327f45347f453580453681443781443982433a83"
        "433b83433c84423d84423e854240854141864142864043874044873f45873f4788"
        "3e48883e49893d4a893d4b893d4c893c4d8a3c4e8a3b508a3b518a3a528b3a538b"
        "39548b39558b38568b38578c37588c37598c365a8c365b8c355c8c355d8c345e8d"
        "345f8d33608d33618d32628d32638d31648d31658d31668d30678d30688d2f698d"
        "2f6a8d2e6b8e2e6c8e2e6d8e2d6e8e2d6f8e2c708e2c718e2c728e2b738e2b748e"
        "2a758e2a768e2a778e29788e29798e287a8e287a8e287b8e277c8e277d8e277e8e"
        "267f8e26808e26818e25828e25838d24848d24858d24868d23878d23888d23898d"
        "22898d228a8d228b8d218c8d218d8c218e8c208f8c20908c20918c1f928c1f938b"
        "1f948b1f958b1f968b1e978a1e988a1e998a1e998a1e9a891e9b891e9c891e9d88"
        "1e9e881e9f881ea0871fa1871fa2861fa38620a48520a58521a68521a78422a784"
        "23a88323a98224aa8225ab8126ac8127ad8028ae7f29af7f2ab07e2bb17d2cb17d"
        "2eb27c2fb37b30b47a32b57a33b67935b77836b87738b97639b9763bba753dbb74"
        "3ebc7340bd7242be7144be7045bf6f47c06e49c16d4bc26c4dc26b4fc36951c468"
        "53c56755c66657c66559c7645bc8625ec96160c96062ca5f64cb5d67cc5c69cc5b"
        "6bcd596dce5870ce5672cf5574d05477d05279d1517cd24f7ed24e81d34c83d34b"
        "86d44988d5478bd5468dd64490d64392d74195d73f97d83e9ad83c9dd93a9fd938"
        "a2da37a5da35a7db33aadb32addc30afdc2eb2dd2cb5dd2bb7dd29bade27bdde26"
        "bfdf24c2df22c5df21c7e01fcae01ecde01dcfe11cd2e11bd4e11ad7e219dae218"
        "dce218dfe318e1e318e4e318e7e419e9e419ece41aeee51bf1e51cf3e51ef6e61f"
        "f8e621fae622fde724"),
    "Blues": (
        "f7fbfff6fafef5f9fef4f9fef3f8fdf3f8fdf2f7fdf1f7fdf0f6fceff6fceff5fc"
        "eef5fcedf4fbecf4fbecf3fbebf3fbeaf2fae9f2fae8f1fae8f1fae7f0f9e6f0f9"
        "e5eff9e4eff9e4eef8e3eef8e2edf8e1edf8e1ecf7e0ecf7dfebf7deebf7ddeaf6"
        "ddeaf6dce9f6dbe9f6dae8f5dae8f5d9e7f5d8e7f5d7e6f4d7e6f4d6e5f4d5e5f4"
        "d4e4f3d4e4f3d3e3f3d2e3f3d1e2f2d1e2f2d0e1f2cfe1f2cee0f1cee0f1cddff1"
        "ccdff1cbdef0cbdef0caddf0c9ddf0c8dcefc8dcefc7dbefc6dbefc5daeec4daee"
        "c3d9eec1d9edc0d8edbfd8ecbed7ecbcd7ebbbd6ebbad6eab9d5eab7d4eab6d4e9"
        "b5d3e9b4d3e8b2d2e8b1d2e7b0d1e7afd1e6add0e6acd0e6abcfe5aacfe5a8cee4"
        "a7cee4a6cde3a5cde3a3cce3a2cbe2a1cbe2a0cae19ecae19dc9e09bc8e09ac7e0"
        "98c7df97c6df95c5df93c4de92c3de90c2de8fc1dd8dc0dd8bc0dd8abfdc88bedc"
        "87bddc85bcdb83bbdb82badb80b9da7fb8da7db8d97bb7d97ab6d978b5d877b4d8"
        "75b3d873b2d772b1d770b1d76fb0d66dafd66baed66aadd569acd567abd466aad4"
        "65aad363a9d362a8d261a7d260a6d15ea5d15da4d05ca3d05aa3cf59a2cf58a1ce"
        "57a0ce559fcd549ecd539dcc519ccc509bcb4f9bcb4e9aca4c99ca4b98c94a97c9"
        "4896c84795c84694c74594c74393c64292c64191c54090c53f8fc43e8ec43d8dc3"
        "3c8cc33b8bc23a8ac13989c13888c03787c03585bf3484bf3383be3282be3181bd"
        "3080bd2f7fbc2e7ebc2d7dbb2c7cbb2b7bba2a7ab92979b92878b82777b82676b7"
        "2575b72474b62373b62272b52171b52070b41f6fb31e6eb21e6db21d6cb11c6bb0"
        "1b6aaf1a69ae1a68ae1967ad1866ac1765ab1764ab1663aa1562a91461a81360a7"
        "135fa7125ea6115da5105ca40f5ba30f5aa30e59a20d58a10c57a00c56a00b559f"
        "0a549e09539d08529c08519c08509a084f99084e97084c96084b94084a92084991"
        "08488f08478e08468c08458b084489084388084286084185084083083f82083e80"
        "083d7e083c7d083b7b083a7a08397808387708377508367408357208347108336f"
        "08326e08316c08306b"),
    "BuPu": (
        "f7fcfdf6fbfcf5fafcf4fafcf4f9fbf3f9fbf2f8fbf1f8fbf1f7faf0f7faeff6fa"
        "eff6f9eef5f9edf5f9ecf4f9ecf4f8ebf3f8eaf3f8eaf2f7e9f2f7e8f1f7e7f1f7"
        "e7f0f6e6f0f6e5eff6e4eff5e4eef5e3eef5e2edf5e2edf4e1ecf4e0ecf4dfebf3"
        "deebf3ddeaf3dce9f2dbe8f2dae7f1d9e7f1d8e6f0d7e5f0d6e4efd5e4efd4e3ef"
        "d3e2eed2e1eed1e0edd0e0edcfdfeccedeeccdddecccddebcbdcebcadbeac9daea"
        "c8d9e9c7d9e9c5d8e8c4d7e8c3d6e8c2d5e7c1d5e7c0d4e6bfd3e6bed2e5bdd2e5"
        "bcd1e5bbd0e4bacfe4b9cfe4b8cee3b7cde3b6cde2b5cce2b4cbe2b3cae1b2cae1"
        "b1c9e1b0c8e0afc7e0aec7dfadc6dfacc5dfabc5deaac4dea9c3dea7c2dda6c2dd"
        "a5c1dca4c0dca3c0dca2bfdba1bedba0bdda9fbdda9ebcda9dbbd99dbad99cb9d8"
        "9cb7d79bb6d79ab5d69ab4d699b3d599b2d498b0d498afd397aed297add296acd1"
        "95aad095a9d094a8cf94a7cf93a6ce93a4cd92a3cd91a2cc91a1cb90a0cb909eca"
        "8f9dca8f9cc98e9bc88d9ac88d98c78c97c68c96c68c95c58c93c58c92c48c91c3"
        "8c8fc38c8ec28c8dc18c8bc18c8ac08c89bf8c87bf8c86be8c85bd8c83bd8c82bc"
        "8c81bb8c7fbb8c7eba8c7db98c7bb98c7ab88c78b78c77b78c76b68c74b58c73b5"
        "8c72b48c70b38c6fb38c6eb28c6cb18c6bb18b6ab08b68af8b67af8b66ae8b64ae"
        "8b63ad8b62ac8b60ac8a5fab8a5eaa8a5daa8a5ba98a5aa98a59a88a57a78a56a7"
        "8955a68953a58952a58951a4894fa4894ea3894da2894ba2884aa18849a08847a0"
        "88469f88459f88439e88429d88419d873f9c873e9b873c9a873b99863998863797"
        "863696863494863393853192853091852e90852c8f842b8e84298d84288c84268b"
        "84258a832389832288832087831e86831d85821b84821a83821882821781811580"
        "81137f81127e81107d810f7c7f0e7a7d0e797c0d777a0d76790c74770c72750b71"
        "740b6f720a6e700a6c6f096b6d09696b08686a0866680865670763650762630660"
        "62065e60055d5e055b5d045a5b04585a035758035556025455025253015151014f"
        "50004e4e004c4d004b"),
    "coolwarm": (
        "3a4cc03b4dc13c4fc33e51c43f53c64054c74156c94258ca435acc455bcd465dcf"
        "475fd04860d14962d34b64d44c66d64d67d74e69d8506bda516cdb526edc5370dd"
        "5571de5673e05775e15876e25a78e35b79e45c7be55d7de65f7ee76080e86182ea"
        "6383ea6485eb6586ec6788ed6889ee698bef6b8df06c8ef16d90f16f91f27093f3"
        "7194f47395f47497f57598f6779af6789bf77a9df87b9ef87ca0f97ea1f97fa2fa"
        "80a4fa82a5fb83a6fb85a8fb86a9fc87aafc89acfc8aadfd8baefd8daffd8eb1fd"
        "90b2fe91b3fe92b4fe94b5fe95b7fe97b8fe98b9fe99bafe9bbbfe9cbcfe9dbdfe"
        "9fbefea0bffea2c0fea3c1fea4c2fea6c3fda7c4fda8c5fdaac6fdabc7fcacc8fc"
        "aec9fcafcafbb0cbfbb2cbfbb3ccfab4cdfab6cef9b7cff9b8cff8b9d0f8bbd1f7"
        "bcd1f6bdd2f6bed3f5c0d3f5c1d4f4c2d4f3c3d5f2c5d5f2c6d6f1c7d6f0c8d7ef"
        "c9d7eecad8eeccd8edcdd9ecced9ebcfd9ead0dae9d1dae8d2dae7d3dbe6d5dbe5"
        "d6dbe4d7dbe2d8dbe1d9dce0dadcdfdbdcdedcdcdddddcdbdedbdadfdbd9e0dad7"
        "e1dad6e2d9d4e3d9d3e4d8d1e5d8d0e6d7cfe7d6cde7d6cce8d5cae9d4c9ead3c7"
        "ebd3c6ecd2c4ecd1c3edd0c1edcfc0eecfbeefcebcefcdbbf0ccb9f1cbb8f1cab6"
        "f2c9b5f2c8b3f2c7b2f3c6b0f3c5aff4c4adf4c3abf4c2aaf5c1a8f5c0a7f5bfa5"
        "f6bda4f6bca2f6bba0f6ba9ff6b99df6b79cf6b69af7b598f7b397f7b295f7b194"
        "f7b092f7ae91f7ad8ff6ab8df6aa8cf6a98af6a789f6a687f6a486f6a384f5a182"
        "f5a081f59e7ff49d7ef49b7cf49a7bf39879f39678f39576f29375f29173f19072"
        "f18e70f08d6ff08b6def896cee876aee8669ed8467ec8266ec8064eb7f63ea7d61"
        "ea7b60e9795ee8775de7755ce6745ae67259e57057e46e56e36c54e26a53e16852"
        "e06650df644fde624edd604cdc5e4bdb5c4ada5a48d95847d85646d75444d65243"
        "d44f42d34d40d24b3fd1493ecf463dce443ccd423acc3f39ca3d38c93b37c83835"
        "c63534c53233c43032c22d31c12a30bf282ebe232dbc1f2cbb1a2bb9162ab81129"
        "b60d28b50827b30326"),
}


def cdiv(a: int, b: int) -> int:
    """C's integer division: the quotient truncated toward zero."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def cv_round(x: float) -> int:
    """``cvRound``: the nearest integer, halves to even."""
    return int(round(x))


def _hline(img: np.ndarray, y: int, x1: int, x2: int, color) -> None:
    img[y, x1:x2 + 1] = color


def _put(img: np.ndarray, x: int, y: int, color) -> None:
    if 0 <= x < img.shape[1] and 0 <= y < img.shape[0]:
        img[y, x] = color


def clip_line(size: Tuple[int, int], p1: list, p2: list) -> bool:
    """``clipLine`` on (width, height): clips both points, in place, to
    the image; False when the line misses it."""
    right, bottom = size[0] - 1, size[1] - 1
    if size[0] <= 0 or size[1] <= 0:
        return False
    x1, y1 = p1
    x2, y2 = p2
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    p1[:] = [x1, y1]
    p2[:] = [x2, y2]
    return (c1 | c2) == 0


def _line2(img: np.ndarray, pt1, pt2, color) -> None:
    """``Line2``: a line between two points in XY_SHIFT fixed point."""
    h, w = img.shape[:2]
    p1, p2 = list(pt1), list(pt2)
    if not clip_line((w << XY_SHIFT, h << XY_SHIFT), p1, p2):
        return
    dx, dy = p2[0] - p1[0], p2[1] - p1[1]
    ax, ay = abs(dx), abs(dy)
    if ax > ay:
        if dx < 0:
            dy = -dy
            p1, p2 = p2, p1
        y_step = cdiv(dy << XY_SHIFT, ax | 1)
        ecount = (p2[0] - p1[0]) >> XY_SHIFT
    else:
        if dy < 0:
            dx = -dx
            p1, p2 = p2, p1
        x_step = cdiv(dx << XY_SHIFT, ay | 1)
        ecount = (p2[1] - p1[1]) >> XY_SHIFT
    x, y = p1[0] + (XY_ONE >> 1), p1[1] + (XY_ONE >> 1)
    _put(img, (p2[0] + (XY_ONE >> 1)) >> XY_SHIFT,
         (p2[1] + (XY_ONE >> 1)) >> XY_SHIFT, color)
    if ax > ay:
        x >>= XY_SHIFT
        while ecount >= 0:
            _put(img, x, y >> XY_SHIFT, color)
            x += 1
            y += y_step
            ecount -= 1
    else:
        y >>= XY_SHIFT
        while ecount >= 0:
            _put(img, x >> XY_SHIFT, y, color)
            x += x_step
            y += 1
            ecount -= 1


def _fill_convex_poly(img: np.ndarray, v: Sequence[Tuple[int, int]],
                      color) -> None:
    """``FillConvexPoly`` of LINE_8 for vertices in XY_SHIFT fixed point:
    the outline by ``Line2``, then the scanlines between the two edges."""
    h, w = img.shape[:2]
    npts = len(v)
    delta = XY_ONE >> 1
    p0 = v[-1]
    xmin = xmax = v[0][0]
    ymin = ymax = v[0][1]
    imin = 0
    for i, p in enumerate(v):
        if p[1] < ymin:
            ymin = p[1]
            imin = i
        ymax = max(ymax, p[1])
        xmax = max(xmax, p[0])
        xmin = min(xmin, p[0])
        _line2(img, p0, p, color)
        p0 = p
    xmin = (xmin + delta) >> XY_SHIFT
    xmax = (xmax + delta) >> XY_SHIFT
    ymin = (ymin + delta) >> XY_SHIFT
    ymax = (ymax + delta) >> XY_SHIFT
    if npts < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    # per edge: [idx, di, x, dx, ye]
    edge = [[imin, 1, -XY_ONE, 0, ymin], [imin, npts - 1, -XY_ONE, 0, ymin]]
    edges = npts
    y = ymin
    while True:
        for e in edge:
            if y >= e[4]:
                idx0, di = e[0], e[1]
                idx = idx0 + di
                if idx >= npts:
                    idx -= npts
                while True:
                    more = edges > 0
                    edges -= 1
                    if not more:
                        break
                    ty = (v[idx][1] + delta) >> XY_SHIFT
                    if ty > y:
                        xs, xe = v[idx0][0], v[idx][0]
                        e[4] = ty
                        e[3] = cdiv((xe - xs) * 2 + (ty - y), 2 * (ty - y))
                        e[2] = xs
                        e[0] = idx
                        break
                    idx0 = idx
                    idx += di
                    if idx >= npts:
                        idx -= npts
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if edge[0][2] > edge[1][2] else (0, 1)
            xx1 = (edge[left][2] + delta) >> XY_SHIFT
            xx2 = (edge[right][2] + delta) >> XY_SHIFT
            if xx2 >= 0 and xx1 < w:
                _hline(img, y, max(xx1, 0), min(xx2, w - 1), color)
        edge[0][2] += edge[0][3]
        edge[1][2] += edge[1][3]
        y += 1
        if y > ymax:
            break


def _circle(img: np.ndarray, cx: int, cy: int, radius: int, color) -> None:
    """``Circle`` filled (its midpoint walk, rows clipped to the image)."""
    h, w = img.shape[:2]
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    inside = radius <= cx < w - radius and radius <= cy < h - radius
    while dx >= dy:
        y11, y12, y21, y22 = cy - dy, cy + dy, cy - dx, cy + dx
        x11, x12, x21, x22 = cx - dx, cx + dx, cx - dy, cx + dy
        if inside:
            for yy, a, b in ((y11, x11, x12), (y12, x11, x12),
                             (y21, x21, x22), (y22, x21, x22)):
                _hline(img, yy, a, b, color)
        elif x11 < w and x12 >= 0 and y21 < h and y22 >= 0:
            x11, x12 = max(x11, 0), min(x12, w - 1)
            for yy in (y11, y12):
                if 0 <= yy < h:
                    _hline(img, yy, x11, x12, color)
            if x21 < w and x22 >= 0:
                x21, x22 = max(x21, 0), min(x22, w - 1)
                for yy in (y21, y22):
                    if 0 <= yy < h:
                        _hline(img, yy, x21, x22, color)
        dy += 1
        err += plus
        plus += 2
        mask = 0 if err <= 0 else -1
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def thick_line(img: np.ndarray, p0: Sequence[int], p1: Sequence[int],
               color, thickness: int, flags: int = 3) -> None:
    """``ThickLine`` of LINE_8 between integer points (x, y), in place on
    an (H, W, C) image: a filled quadrilateral of width ``thickness`` and,
    by ``flags`` (bit 0 the start, bit 1 the end), filled circles of half
    the width at the ends. ``cv2.line`` draws with flags 3."""
    if thickness < 2:
        raise NotImplementedError(
            f"thickness {thickness}: only cv2's thick lines (2 or more) are "
            "ported")
    color = np.asarray(color, img.dtype)
    x0, y0 = int(p0[0]) << XY_SHIFT, int(p0[1]) << XY_SHIFT
    x1, y1 = int(p1[0]) << XY_SHIFT, int(p1[1]) << XY_SHIFT
    dx = (x0 - x1) / XY_ONE
    dy = (y1 - y0) / XY_ONE
    r = dx * dx + dy * dy
    odd = thickness & 1
    th = thickness << (XY_SHIFT - 1)
    if math.fabs(r) > _DBL_EPSILON:
        r = (th + odd * XY_ONE * 0.5) / math.sqrt(r)
        dpx, dpy = cv_round(dy * r), cv_round(dx * r)
        _fill_convex_poly(img, [(x0 + dpx, y0 + dpy), (x0 - dpx, y0 - dpy),
                                (x1 - dpx, y1 - dpy), (x1 + dpx, y1 + dpy)],
                          color)
    radius = (th + (XY_ONE >> 1)) >> XY_SHIFT
    for i, (x, y) in enumerate(((x0, y0), (x1, y1))):
        if flags & (i + 1):
            _circle(img, (x + (XY_ONE >> 1)) >> XY_SHIFT,
                    (y + (XY_ONE >> 1)) >> XY_SHIFT, radius, color)


def line(img: np.ndarray, p0, p1, color, thickness: int) -> None:
    """``cv2.line(img, p0, p1, color, thickness)`` for thickness >= 2."""
    thick_line(img, p0, p1, color, thickness, flags=3)


def rectangle(img: np.ndarray, p1, p2, color, thickness: int) -> None:
    """``cv2.rectangle(img, p1, p2, color, thickness)`` for thickness >=
    2: the closed polyline p1, (p2.x, p1.y), p2, (p1.x, p2.y), each side a
    thick line with a round join at its end."""
    pts = [(p1[0], p1[1]), (p2[0], p1[1]), (p2[0], p2[1]), (p1[0], p2[1])]
    prev = pts[-1]
    for p in pts:
        thick_line(img, prev, p, color, thickness, flags=2)
        prev = p


# -- colour maps -------------------------------------------------------------


def colormap_lut(name: str) -> np.ndarray:
    """(N, 3) uint8 RGB: matplotlib's colour map ``name`` as
    ``Colormap(np.arange(N), bytes=True)`` gives it."""
    if name not in _LUT_HEX:
        raise ValueError(f"colour map {name!r} is not one of the port's "
                         f"{sorted(_LUT_HEX)}")
    return np.frombuffer(bytes.fromhex(_LUT_HEX[name]),
                         np.uint8).reshape(-1, 3)


def map_colours(values, name: str, vmin=None, vmax=None) -> np.ndarray:
    """(..., 3) uint8 RGB of ``values`` under matplotlib's linear norm from
    ``vmin`` to ``vmax`` (default the values' range) and colour map
    ``name``: entry ``floor(frac * N)``, clipped to the table, as
    ``Colormap.__call__`` picks it."""
    lut = colormap_lut(name)
    v = np.asarray(values, np.float64)
    lo = np.min(v) if vmin is None else vmin
    hi = np.max(v) if vmax is None else vmax
    frac = (v - lo) / (hi - lo) if hi > lo else np.zeros_like(v)
    idx = np.clip(np.floor(frac * len(lut)), 0, len(lut) - 1).astype(int)
    return lut[idx]
