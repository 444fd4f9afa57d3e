"""The port's figures (``analysis/plots.py``, ``analysis/raster.py``)
against the JAX package's ``dynamorph_tpu.analysis.plots`` on the CPU.

- Every public function of the JAX module has a counterpart of the same
  name and parameters.
- The image helpers write the JAX package's pixels: the 16-bit patch PNGs,
  the GIF's frames and durations, the instance blend (cv2's BGR file
  order), the boxes and the trajectory lines (cv2 5.0's rasteriser), at
  thickness 1 and filled too.
  The rasteriser is also held against cv2 on random lines and rectangles,
  thin, thick and filled, with ends inside and outside the image, and
  refuses the thicknesses cv2 refuses.
- The matplotlib figures: the numbers the JAX figures plot (recorded from
  matplotlib's ``Axes`` calls) equal the port's, and the colour tables
  equal matplotlib's, for every map it registers.
- The densities: seaborn's and matplotlib's own computations within 1e-10
  relative.
"""
import inspect
import os

import cv2
import matplotlib
import matplotlib.axes
import numpy as np
import pytest
from PIL import Image

from dynamorph_tpu.analysis import plots as jax_plots
from dynamorph_tpu_torch.analysis import plots, raster

RNG_SEED = 7
KDE_RTOL = 1e-10


def _public(module):
    return {n: f for n, f in vars(module).items()
            if inspect.isfunction(f) and not n.startswith("_")
            and f.__module__ == module.__name__}


def test_every_jax_figure_has_a_counterpart():
    ours = vars(plots)
    for name, fn in _public(jax_plots).items():
        assert name in ours, name
        assert list(inspect.signature(ours[name]).parameters.values()) == \
            list(inspect.signature(fn).parameters.values()), name


def _frame(rng, h=96, w=128):
    return rng.randint(0, 65536, (h, w)).astype(np.uint16)


def _same_png(a, b):
    x = cv2.imread(a, cv2.IMREAD_UNCHANGED)
    y = cv2.imread(b, cv2.IMREAD_UNCHANGED)
    assert x.dtype == y.dtype and x.shape == y.shape
    np.testing.assert_array_equal(x, y)


# ---------------------------------------------------- the image helpers


def test_plot_patches_pixels_match_jax(tmp_path):
    patches = np.random.RandomState(RNG_SEED).randint(0, 65536, (3, 20, 24))
    ours = plots.plot_patches(patches, str(tmp_path / "port"))
    ref = jax_plots.plot_patches(patches, str(tmp_path / "jax"))
    assert [os.path.basename(p) for p in ours] == \
        [os.path.basename(p) for p in ref]
    for a, b in zip(ours, ref):
        assert cv2.imread(a, cv2.IMREAD_UNCHANGED).dtype == np.uint16
        _same_png(a, b)


def _gif(path):
    im = Image.open(path)
    frames, durations = [], []
    for i in range(im.n_frames):
        im.seek(i)
        frames.append(np.asarray(im.convert("L")))
        durations.append(im.info["duration"])
    return np.stack(frames), durations


@pytest.mark.parametrize("fps", [5, 3])
def test_patch_movie_frames_and_durations_match_jax(tmp_path, fps):
    patches = np.random.RandomState(fps).randint(0, 65536, (4, 16, 16))
    fa, da = _gif(plots.save_patch_movie(patches, str(tmp_path / "a.gif"),
                                         fps=fps))
    fb, db = _gif(jax_plots.save_patch_movie(patches,
                                             str(tmp_path / "b.gif"),
                                             fps=fps))
    np.testing.assert_array_equal(fa, fb)
    # GIF keeps centiseconds
    assert da == db == [10 * round(100 / fps)] * 4


def test_instance_separation_pixels_match_jax(tmp_path):
    rng = np.random.RandomState(RNG_SEED)
    frame = _frame(rng)
    pos = np.argwhere(rng.rand(*frame.shape) > 0.7)
    labels = rng.randint(-1, 13, len(pos))
    _same_png(plots.plot_instance_separation(frame, pos, labels,
                                             str(tmp_path / "a.png")),
              jax_plots.plot_instance_separation(frame, pos, labels,
                                                 str(tmp_path / "b.png")))


def test_cell_boxes_pixels_match_jax(tmp_path):
    """Boxes inside the frame and across each of its edges (clamped as
    the JAX function clamps them), default and given colours and
    thickness."""
    rng = np.random.RandomState(RNG_SEED)
    frame = _frame(rng, 160, 200)
    centers = [(80, 100), (5, 7), (150, 195), (0, 120), (159, 0),
               (40, 199)] + [tuple(c) for c in rng.randint(0, 160, (6, 2))]
    colors = [tuple(int(v) for v in c) for c in rng.randint(0, 256, (12, 3))]
    for kw in ({}, dict(colors=colors, half=20, thickness=2)):
        _same_png(plots.draw_cell_boxes(frame, centers,
                                        str(tmp_path / "a.png"), **kw),
                  jax_plots.draw_cell_boxes(frame, centers,
                                            str(tmp_path / "b.png"), **kw))


@pytest.mark.parametrize("thickness", [1, 0, -1])
def test_thin_and_filled_boxes_and_trajectories_match_jax(tmp_path,
                                                          thickness):
    """Boxes at thickness 1, 0 and cv2.FILLED across the frame's edges;
    a trajectory at thickness 1, and refused by both packages at 0 and
    -1, as cv2.line refuses them."""
    rng = np.random.RandomState(RNG_SEED + thickness)
    frame = _frame(rng, 120, 150)
    centers = [(60, 75), (3, 4), (119, 149)] + \
        [tuple(c) for c in rng.randint(0, 120, (5, 2))]
    _same_png(plots.draw_cell_boxes(frame, centers, str(tmp_path / "a.png"),
                                    half=15, thickness=thickness),
              jax_plots.draw_cell_boxes(frame, centers,
                                        str(tmp_path / "b.png"), half=15,
                                        thickness=thickness))
    positions = 500 + np.clip(np.cumsum(rng.randint(-9, 10, (12, 2)), 0),
                              -70, 70)
    if thickness == 1:
        _same_png(plots.plot_trajectory_on_frame(
                      frame, positions, str(tmp_path / "c.png"),
                      thickness=1),
                  jax_plots.plot_trajectory_on_frame(
                      frame, positions, str(tmp_path / "d.png"),
                      thickness=1))
        return
    with pytest.raises(cv2.error):
        jax_plots.plot_trajectory_on_frame(frame, positions,
                                           str(tmp_path / "d.png"),
                                           thickness=thickness)
    with pytest.raises(ValueError, match="thickness"):
        plots.plot_trajectory_on_frame(frame, positions,
                                       str(tmp_path / "c.png"),
                                       thickness=thickness)


@pytest.mark.parametrize("seed", range(4))
def test_trajectory_pixels_match_jax(tmp_path, seed):
    """A wandering trajectory on its crop (the default origin centres its
    start), thickness 2 and 3."""
    rng = np.random.RandomState(seed)
    frame = _frame(rng, 128, 128)
    steps = rng.randint(-9, 10, (12, 2))
    positions = 500 + np.clip(np.cumsum(steps, 0), -60, 60)
    for kw in ({}, dict(color=(10, 200, 30), thickness=3)):
        _same_png(plots.plot_trajectory_on_frame(
                      frame, positions, str(tmp_path / "a.png"), **kw),
                  jax_plots.plot_trajectory_on_frame(
                      frame, positions, str(tmp_path / "b.png"), **kw))


def test_thick_lines_and_rectangles_match_cv2():
    """cv2.line (both ends in the image) and cv2.rectangle (anywhere) at
    thickness 2-7 on random images, bit for bit."""
    rng = np.random.RandomState(RNG_SEED)
    for _ in range(400):
        h, w = (int(v) for v in rng.randint(4, 70, 2))
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        th = int(rng.choice([2, 3, 4, 5, 7]))
        col = tuple(int(c) for c in rng.randint(0, 256, 3))
        p = (int(rng.randint(w)), int(rng.randint(h)))
        q = (int(rng.randint(w)), int(rng.randint(h)))
        a, b = img.copy(), img.copy()
        cv2.line(a, p, q, col, th)
        raster.line(b, p, q, col, th)
        np.testing.assert_array_equal(a, b, err_msg=f"line {p} {q} {th}")
        p = tuple(int(v) for v in rng.randint(-15, max(h, w) + 15, 2))
        q = tuple(int(v) for v in rng.randint(-15, max(h, w) + 15, 2))
        a, b = img.copy(), img.copy()
        cv2.rectangle(a, p, q, col, th)
        raster.rectangle(b, p, q, col, th)
        np.testing.assert_array_equal(a, b, err_msg=f"rect {p} {q} {th}")


@pytest.mark.parametrize("seed", range(3))
def test_thin_and_clipped_lines_and_filled_rectangles_match_cv2(seed):
    """cv2.line at thickness 1-9 and cv2.rectangle at -3..3 (thin sides at
    0 and 1, filled below 0), with ends inside and up to 25 pixels outside
    the image, bit for bit."""
    rng = np.random.RandomState(100 + seed)
    for _ in range(300):
        h, w = (int(v) for v in rng.randint(1, 50, 2))
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        col = tuple(int(c) for c in rng.randint(0, 256, 3))
        p = tuple(int(v) for v in rng.randint(-25, max(h, w) + 25, 2))
        q = tuple(int(v) for v in rng.randint(-25, max(h, w) + 25, 2))
        th = int(rng.choice([1, 1, 2, 3, 4, 9]))
        a, b = img.copy(), img.copy()
        cv2.line(a, p, q, col, th)
        raster.line(b, p, q, col, th)
        np.testing.assert_array_equal(a, b, err_msg=f"line {p} {q} {th}")
        th = int(rng.randint(-3, 4))
        a, b = img.copy(), img.copy()
        cv2.rectangle(a, p, q, col, th)
        raster.rectangle(b, p, q, col, th)
        np.testing.assert_array_equal(a, b, err_msg=f"rect {p} {q} {th}")


def test_thin_lines_are_refused():
    """The thicknesses cv2 refuses: a line's 0, -1 and over MAX_THICKNESS,
    a rectangle's over MAX_THICKNESS (0 and below draw)."""
    for th in (0, -1, raster.MAX_THICKNESS + 1):
        with pytest.raises(cv2.error):
            cv2.line(np.zeros((4, 4, 3), np.uint8), (0, 0), (3, 3),
                     (1, 1, 1), th)
        with pytest.raises(ValueError, match="thickness"):
            raster.line(np.zeros((4, 4, 3), np.uint8), (0, 0), (3, 3),
                        (1, 1, 1), th)
    with pytest.raises(cv2.error):
        cv2.rectangle(np.zeros((4, 4, 3), np.uint8), (0, 0), (3, 3),
                      (1, 1, 1), raster.MAX_THICKNESS + 1)
    with pytest.raises(ValueError, match="thickness"):
        raster.rectangle(np.zeros((4, 4, 3), np.uint8), (0, 0), (3, 3),
                         (1, 1, 1), raster.MAX_THICKNESS + 1)


# ------------------------------------------------------------ the colours


@pytest.mark.parametrize("name", sorted(matplotlib.colormaps))
def test_colour_tables_are_matplotlibs(name):
    cmap = matplotlib.colormaps[name]
    np.testing.assert_array_equal(
        raster.colormap_lut(name),
        cmap(np.arange(cmap.N), bytes=True)[:, :3])
    v = np.r_[np.random.RandomState(len(name)).randn(300), -3.0, 4.0]
    norm = matplotlib.colors.Normalize(v.min(), v.max())
    np.testing.assert_array_equal(raster.map_colours(v, name),
                                  cmap(norm(v), bytes=True)[:, :3])
    with pytest.raises(ValueError, match="not a valid value for cmap"):
        raster.colormap_lut(name + "_unknown")


def test_class_probability_panels_are_viridis(tmp_path):
    probs = np.random.RandomState(RNG_SEED).rand(3, 40, 50)
    probs[0, 0, :3] = [0.0, 1.0, 0.5]
    path = plots.plot_class_probabilities(probs, str(tmp_path / "p.png"))
    rgb = cv2.imread(path)[..., ::-1]
    want = matplotlib.colormaps["viridis"](probs, bytes=True)[..., :3]
    for i in range(3):
        x0 = i * (50 + plots.GAP)
        np.testing.assert_array_equal(rgb[:, x0:x0 + 50], want[i])


# ------------------------------------------- the numbers the figures plot


@pytest.fixture
def recorded(monkeypatch):
    """Records the matplotlib Axes calls of the JAX figures."""
    calls = []

    def wrap(name):
        real = getattr(matplotlib.axes.Axes, name)

        def method(self, *a, **k):
            out = real(self, *a, **k)
            calls.append((name, a, k, out))
            return out
        monkeypatch.setattr(matplotlib.axes.Axes, name, method)

    for name in ("plot", "scatter", "imshow", "set_xlim", "set_ylim",
                 "hist2d"):
        wrap(name)
    return calls


def _calls(recorded, name):
    return [c for c in recorded if c[0] == name]


def test_frame_matching_segments_match_jax(tmp_path, recorded):
    rng = np.random.RandomState(RNG_SEED)
    f0, f1 = _frame(rng, 60, 70), _frame(rng, 50, 80)
    p0, p1 = rng.rand(6, 2) * 50, rng.rand(5, 2) * 50
    pairs = [(0, 1), (2, 0), (5, 4), (3, 3)]
    jax_plots.plot_frame_matching(f0, f1, p0, p1, pairs,
                                  str(tmp_path / "b.png"))
    drawn = [(tuple(a[0]), tuple(a[1])) for _, a, _, _ in
             _calls(recorded, "plot")]
    assert drawn == plots.frame_matching_segments(70, p0, p1, pairs)
    plots.plot_frame_matching(f0, f1, p0, p1, pairs, str(tmp_path / "a.png"))
    assert cv2.imread(str(tmp_path / "a.png")).shape == (60, 170, 3)


def test_explained_variance_and_correlations_match_jax(tmp_path, recorded):
    rng = np.random.RandomState(RNG_SEED)
    ratio = np.sort(rng.rand(12))[::-1] / 12
    jax_plots.plot_explained_variance(ratio, str(tmp_path / "b.png"))
    (_, (x, y, _), _, _), = _calls(recorded, "plot")
    ox, oy = plots.explained_variance_curve(ratio)
    np.testing.assert_array_equal(ox, x)
    np.testing.assert_array_equal(oy, y)
    comps = rng.randn(80, 9)
    props = {"area": rng.rand(80), "speed": rng.randn(80) + comps[:, 1]}
    jax_plots.plot_correlation_matrix(comps, props, str(tmp_path / "c.png"),
                                      n_components=4)
    (_, (mat,), _, _), = _calls(recorded, "imshow")
    np.testing.assert_array_equal(
        plots.correlation_matrix(comps, props, n_components=4), mat)
    for path, fn, args in (
            ("ev.png", plots.plot_explained_variance, (ratio,)),
            ("cm.png", plots.plot_correlation_matrix, (comps, props))):
        fn(*args, str(tmp_path / path))
        assert cv2.imread(str(tmp_path / path)) is not None


@pytest.mark.parametrize("colouring", ["labels", "values", "none"])
def test_embedding_points_and_limits_match_jax(tmp_path, recorded,
                                              colouring):
    rng = np.random.RandomState(RNG_SEED)
    emb = rng.randn(400, 3)
    kw = {"labels": dict(labels=np.repeat([0, 1, 2, 3], 100)),
          "values": dict(values=rng.rand(400), cmap="BuPu"),
          "none": {}}[colouring]
    jax_plots.plot_embedding_scatter(emb, str(tmp_path / "b.png"),
                                     zoom_cutoff=2.0, dims=(2, 0), **kw)
    (_, (sx, sy), sk, _), = _calls(recorded, "scatter")
    # zoom_axis's calls (matplotlib makes others of its own)
    (_, _, xk, _), = [c for c in _calls(recorded, "set_xlim")
                      if "left" in c[2]]
    (_, _, yk, _), = [c for c in _calls(recorded, "set_ylim")
                      if "bottom" in c[2]]
    x, y, colours, filled, xlim, ylim = plots.embedding_points(
        emb, zoom_cutoff=2.0, dims=(2, 0), **kw)
    np.testing.assert_array_equal(x, sx)
    np.testing.assert_array_equal(y, sy)
    assert xlim == [xk["left"], xk["right"]]
    assert ylim == [yk["bottom"], yk["top"]]
    assert filled == (colouring != "labels")
    if "c" in sk:
        cmap = matplotlib.colormaps[sk["cmap"]]
        c = np.asarray(sk["c"], np.float64)
        want = cmap(matplotlib.colors.Normalize(c.min(), c.max())(c),
                    bytes=True)[:, :3]
        np.testing.assert_array_equal(colours, want)
    plots.plot_embedding_scatter(emb, str(tmp_path / "a.png"),
                                 zoom_cutoff=2.0, dims=(2, 0), **kw)
    assert cv2.imread(str(tmp_path / "a.png")).shape[:2] == (1440, 1920)


def test_pc_vs_property_matches_jax(tmp_path, recorded):
    rng = np.random.RandomState(RNG_SEED)
    pc, prop = rng.randn(300), rng.rand(300) + 0.05
    jax_plots.plot_pc_vs_property(pc, prop, str(tmp_path / "b.png"),
                                  log_prop=True, density=True)
    (_, (hx, hy), hk, out), = _calls(recorded, "hist2d")
    x, p = plots.pc_property_values(pc, prop, log_prop=True)
    np.testing.assert_array_equal(x, hx)
    np.testing.assert_array_equal(p, hy)
    np.testing.assert_array_equal(np.histogram2d(x, p, bins=40)[0], out[0])
    for density in (True, False):
        plots.plot_pc_vs_property(pc, prop, str(tmp_path / "a.png"),
                                  log_prop=True, density=density)
        assert cv2.imread(str(tmp_path / "a.png")) is not None


def test_force_aspect_matches_jax():
    from matplotlib.figure import Figure

    ax = Figure().add_subplot(111)
    ax.set_xlim(-3.0, 5.0)
    ax.set_ylim(2.0, 0.5)
    jax_plots.force_aspect(ax, 2.0)
    assert plots.force_aspect((ax.get_xlim(), ax.get_ylim()), 2.0) == \
        ax.get_aspect()


# ---------------------------------------------------------- the densities


def test_kde_curves_match_seaborn(tmp_path):
    from seaborn._statistics import KDE

    rng = np.random.RandomState(RNG_SEED)
    x = rng.randn(150) * 2 + 1
    support, density = plots.kde_curve(x)
    ref_density, ref_support = KDE()(x)
    assert len(support) == 200
    np.testing.assert_allclose(support, ref_support, rtol=KDE_RTOL, atol=0)
    np.testing.assert_allclose(density, ref_density, rtol=KDE_RTOL, atol=0)
    y = 0.5 * x + rng.randn(150)
    gx, gy, dens, levels = plots.joint_kde(x, y)
    ref, (rx, ry) = KDE()(x, y)
    np.testing.assert_allclose(gx, rx, rtol=KDE_RTOL, atol=0)
    np.testing.assert_allclose(gy, ry, rtol=KDE_RTOL, atol=0)
    np.testing.assert_allclose(dens, ref, rtol=KDE_RTOL, atol=0)
    from seaborn.distributions import _DistributionPlotter

    np.testing.assert_array_equal(
        levels, _DistributionPlotter._quantile_to_level(
            None, ref, np.linspace(0.05, 1, 10)))
    plots.plot_distribution_comparison(x[:50], x, str(tmp_path / "d.png"))
    plots.plot_joint_kde(x, y, str(tmp_path / "j.png"))
    for name in ("d.png", "j.png"):
        assert cv2.imread(str(tmp_path / name)) is not None


def test_violin_stats_match_matplotlib(tmp_path):
    from matplotlib import cbook, mlab

    rng = np.random.RandomState(RNG_SEED)
    groups = {"a": rng.randn(60), "b": rng.gamma(2.0, size=90),
              "flat": np.full(5, 3.0)}

    def kde_method(x, coords):
        if np.all(x[0] == x):
            return (x[0] == coords).astype(float)
        return mlab.GaussianKDE(x, None).evaluate(coords)

    ref = cbook.violin_stats(list(groups.values()), kde_method, points=100)
    ours = plots.violin_stats(list(groups.values()))
    for o, r in zip(ours, ref):
        np.testing.assert_array_equal(o["coords"], r["coords"])
        np.testing.assert_allclose(o["vals"], r["vals"], rtol=KDE_RTOL,
                                   atol=0)
        for k in ("mean", "median", "min", "max"):
            assert o[k] == r[k]
    plots.plot_violin_modes(groups, str(tmp_path / "v.png"))
    assert cv2.imread(str(tmp_path / "v.png")) is not None
