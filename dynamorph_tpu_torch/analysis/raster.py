"""Drawing on numpy images without cv2 or matplotlib: cv2's lines and
rectangles bit for bit, matplotlib's colour maps as lookup tables, and
the small primitives of the port's figures (``analysis/plots.py``).

cv2's lines (``cv2.line``, ``cv2.rectangle``; the default LINE_8) follow
OpenCV's ``drawing.cpp`` step for step, with C's integer arithmetic
(truncating division, arithmetic shifts) and ``cvRound``'s round half to
even:

- thickness 1 (and a rectangle's 0) is ``Line``: the 8-connected
  ``LineIterator`` walk, left to right, clipped to the image by
  ``clipLine`` when an end lies outside it;
- thickness 2 or more is ``ThickLine``'s polygon in 16-bit fixed point:
  a quadrilateral of the line's width filled by ``FillConvexPoly`` (its
  edges traced by ``Line2``, clipped by ``clipLine``), and filled circles
  of half the width at the ends (``Circle``), so consecutive segments join
  round. cv2 5.0 first clips such a segment to the image grown by the
  thickness on every side (``clipLine`` on that rectangle), so a segment
  with an end outside the image is drawn between its clipped ends;
- a rectangle of negative thickness (``cv2.FILLED``) is ``FillConvexPoly``
  of its four corners in whole pixels, its edges traced by ``Line``.

All of it equals the installed cv2 5.0 on the tests' random inputs
(``tests/test_torch_plots.py``).

The colour maps are matplotlib's, copied as 8-bit tables
(``colormaps.npz``, written by ``tools/make_colormaps.py``): the colours
``Colormap(values, bytes=True)`` gives, for every map matplotlib
registers.
"""
from __future__ import annotations

import functools
import math
import os
from typing import Dict, Sequence, Tuple

import numpy as np

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT
_DBL_EPSILON = 2.220446049250313e-16
# cv2's MAX_THICKNESS (drawing.cpp)
MAX_THICKNESS = 32767
_COLORMAPS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "colormaps.npz")


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


def _line8(img: np.ndarray, pt1, pt2, color) -> None:
    """``Line`` of LINE_8 between integer points: ``LineIterator``'s
    8-connected walk (left to right), both ends clipped by ``clipLine``
    when either lies outside the image."""
    h, w = img.shape[:2]
    p1, p2 = [int(v) for v in pt1], [int(v) for v in pt2]
    if not (0 <= p1[0] < w and 0 <= p2[0] < w
            and 0 <= p1[1] < h and 0 <= p2[1] < h):
        if not clip_line((w, h), p1, p2):
            return
    dx, dy = p2[0] - p1[0], p2[1] - p1[1]
    if dx < 0:
        dx, dy = -dx, -dy
        p1, p2 = p2, p1
    step_y = 1
    if dy < 0:
        dy, step_y = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    err = dx - (dy + dy)
    x, y = p1
    for _ in range(dx + 1):
        img[y, x] = color
        minor = err < 0
        err += -(dy + dy) + ((dx + dx) if minor else 0)
        if vert:
            y += step_y
            x += minor
        else:
            x += 1
            y += step_y if minor else 0


def _fill_convex_poly(img: np.ndarray, v: Sequence[Tuple[int, int]],
                      color, shift: int = XY_SHIFT) -> None:
    """``FillConvexPoly`` of LINE_8 for vertices in ``shift`` fixed point:
    the outline (by ``Line`` on whole pixels when ``shift`` is 0, else by
    ``Line2``), then the scanlines between the two edges."""
    h, w = img.shape[:2]
    npts = len(v)
    delta = (1 << shift) >> 1
    up = XY_SHIFT - shift
    p0 = (v[-1][0] << up, v[-1][1] << up)
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
        p = (p[0] << up, p[1] << up)
        if shift == 0:
            _line8(img, (p0[0] >> XY_SHIFT, p0[1] >> XY_SHIFT),
                   (p[0] >> XY_SHIFT, p[1] >> XY_SHIFT), color)
        else:
            _line2(img, p0, p, color)
        p0 = p
    xmin = (xmin + delta) >> shift
    xmax = (xmax + delta) >> shift
    ymin = (ymin + delta) >> shift
    ymax = (ymax + delta) >> shift
    if npts < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    half = XY_ONE >> 1
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
                    ty = (v[idx][1] + delta) >> shift
                    if ty > y:
                        xs, xe = v[idx0][0] << up, v[idx][0] << up
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
            xx1 = (edge[left][2] + half) >> XY_SHIFT
            xx2 = (edge[right][2] + half) >> XY_SHIFT
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
    an (H, W, C) image. At thickness 1 or less the 8-connected ``Line``;
    above, the segment clipped to the image grown by ``thickness`` on each
    side (cv2 5.0), then a filled quadrilateral of width ``thickness`` and,
    by ``flags`` (bit 0 the start, bit 1 the end), filled circles of half
    the width at the ends. ``cv2.line`` draws with flags 3."""
    color = np.asarray(color, img.dtype)
    if thickness <= 1:
        _line8(img, p0, p1, color)
        return
    h, w = img.shape[:2]
    a, b = [int(v) + thickness for v in p0], [int(v) + thickness for v in p1]
    if not clip_line((w + 2 * thickness, h + 2 * thickness), a, b):
        return
    x0, y0 = (a[0] - thickness) << XY_SHIFT, (a[1] - thickness) << XY_SHIFT
    x1, y1 = (b[0] - thickness) << XY_SHIFT, (b[1] - thickness) << XY_SHIFT
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
    """``cv2.line(img, p0, p1, color, thickness)``; like cv2, a thickness
    outside [1, MAX_THICKNESS] raises."""
    if not 0 < thickness <= MAX_THICKNESS:
        raise ValueError(f"line thickness {thickness} is outside "
                         f"[1, {MAX_THICKNESS}]")
    thick_line(img, p0, p1, color, thickness, flags=3)


def rectangle(img: np.ndarray, p1, p2, color, thickness: int) -> None:
    """``cv2.rectangle(img, p1, p2, color, thickness)``: the closed
    polyline p1, (p2.x, p1.y), p2, (p1.x, p2.y), each side a line of
    ``thickness`` (thin at 0 or 1) with a round join at its end, or at a
    negative thickness (``cv2.FILLED``) those corners filled. Like cv2, a
    thickness over MAX_THICKNESS raises."""
    if thickness > MAX_THICKNESS:
        raise ValueError(f"rectangle thickness {thickness} is over "
                         f"{MAX_THICKNESS}")
    pts = [(int(p1[0]), int(p1[1])), (int(p2[0]), int(p1[1])),
           (int(p2[0]), int(p2[1])), (int(p1[0]), int(p2[1]))]
    if thickness < 0:
        _fill_convex_poly(img, pts, np.asarray(color, img.dtype), shift=0)
        return
    prev = pts[-1]
    for p in pts:
        thick_line(img, prev, p, color, thickness, flags=2)
        prev = p


# -- colour maps -------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _colormap_tables() -> Dict[str, np.ndarray]:
    with np.load(_COLORMAPS) as f:
        return {name: f[name] for name in f.files}


def colormap_lut(name: str) -> np.ndarray:
    """(N, 3) uint8 RGB: matplotlib's colour map ``name`` as
    ``Colormap(np.arange(N), bytes=True)`` gives it, at the map's own N.
    A name matplotlib does not register raises ``ValueError``, as
    ``matplotlib.colormaps[name]`` refuses it."""
    tables = _colormap_tables()
    if name not in tables:
        raise ValueError(f"{name!r} is not a valid value for cmap; supported "
                         f"values are {', '.join(map(repr, sorted(tables)))}")
    return tables[name].copy()


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
