"""The port's staged middle of the pipeline (instance segmentation, patch
extraction, tracking, VAE dataset assembly, trajectory matching) against
the JAX package on the CPU, on one synthetic site.

The site: 12 frames of 2 x 256 x 256 uint16-valued intensities with four
drifting disk cells (one near the top border, so its window crosses the
frame edge, and one within another's window), and a 3-class probability
map made from the cell masks. A second site in another well drives the
filters and the gap closing: 14 frames with a cell that misses one frame
(a gap of 2), one that misses two (a gap of 3), a decoy that vanishes
within 100 px of a gap's far end, a cell that appears at t = 5, one under
500 px and one L-shaped cell with more than 5% of its pixels outside its
256 window. The JAX chain runs once per module
(``dynamorph_tpu`` stage functions; its DBSCAN on sklearn, the reference
it stands for, so that no native build of the JAX package starts here),
the port's through its CLIs with ``--device cpu``. Patch window 64,
``input_size`` 32 (the factor 2 of the default 256 -> 128).

Every artifact must be equal: the pickles, the patch arrays bit for bit,
the static patches bit for bit. ``_resize_chw`` equals ``cv2.resize``
bit for bit on 2-channel patches (the pipeline's) at every size; cv2 5.0
takes another path for 1-channel arrays, held to ``RESIZE_RTOL`` and
``RESIZE_RTOL_INT`` of the array's largest magnitude.
"""
import os
import pickle

import cv2
import matplotlib
import numpy as np
import pytest
import torch

from dynamorph_tpu.config.schema import (LatentEncodingConfig as JaxLE,
                                         PipelineConfig as JaxPC)
from dynamorph_tpu.ops import patch as jax_patch_ops
from dynamorph_tpu.pipeline import patch as jax_patch
from dynamorph_tpu.pipeline import patch_vae as jax_patch_vae
from dynamorph_tpu.track import clustering as jax_clustering
from dynamorph_tpu.pipeline.orchestrator import \
    run_pipeline as jax_run_pipeline
from dynamorph_tpu_torch.cli import (run_patch, run_pipeline,
                                     run_segmentation, run_vae)
from dynamorph_tpu_torch.config import load_config
from dynamorph_tpu_torch.io.compact import load_stack_any
from dynamorph_tpu_torch.io.pickles import load_pickle, save_pickle
from dynamorph_tpu_torch.ops.patch import (extract_cell_patches,
                                           labels_to_map, median_background)
from dynamorph_tpu_torch.pipeline import patch as port_patch
from dynamorph_tpu_torch.pipeline.patch_vae import (_resize_chw,
                                                    combine_dataset)
from test_torch_train import _few_threads  # noqa: F401

SITE = "B2-Site_0"
WELL = "B2"
T = 12
SIZE = 256
WINDOW = 64
INPUT = 32
RADIUS = 18
# cell centres at t = 0 and their drift, px per frame: A near the top
# border, B 50 px below it (inside A's window) moving with it
CENTERS0 = np.array([[26, 70], [76, 70], [170, 180], [196, 60]])
DRIFT = np.array([[0.8, 1.2], [0.8, 1.2], [-1.5, -0.7], [-0.6, 1.4]])
# _resize_chw against cv2.resize where they are not bit-equal (1-channel
# arrays; 2-channel ones, the pipeline's, are), relative to the largest
# magnitude. Measured here: 2.3e-6 at non-integer factors, 1.2e-16 at
# integer ones on random float64 values.
RESIZE_RTOL = 2.5e-6
RESIZE_RTOL_INT = 1e-15

# the second site: (y, x) at t = 0, drift px per frame, frames present
EDGE_SITE = "C3-Site_0"
EDGE_T = 14
EDGE_CELLS = {
    "gap2": ((40, 40), (0.4, 0.4), set(range(EDGE_T)) - {5}),
    "decoy": ((40, 100), (0.0, 0.0), set(range(5))),
    "gap3": ((40, 210), (0.4, 0.0), set(range(EDGE_T)) - {5, 6}),
    "late": ((150, 130), (0.4, 0.4), set(range(5, EDGE_T))),
    "steady": ((200, 40), (-0.5, 0.5), set(range(EDGE_T))),
}


def _site(seed=0):
    """(T, 2, 1, S, S) float64 raw stack (integers in the uint16 range)
    and the (T, 3, 1, S, S) float64 probabilities."""
    r = np.random.RandomState(seed)
    yy, xx = np.mgrid[:SIZE, :SIZE]
    raw = r.randint(28000, 31000, (T, 2, 1, SIZE, SIZE)).astype(np.float64)
    probs = np.empty((T, 3, 1, SIZE, SIZE))
    for t in range(T):
        centers = np.rint(CENTERS0 + DRIFT * t).astype(int)
        d = np.linalg.norm(centers[:, None] - centers[None], axis=-1)
        assert d[np.triu_indices(len(centers), 1)].min() >= 2 * RADIUS + 12
        fg = np.zeros((SIZE, SIZE), bool)
        for cy, cx in centers:
            cell = (yy - cy) ** 2 + (xx - cx) ** 2 < RADIUS ** 2
            fg |= cell
            raw[t, 0, 0][cell] += r.randint(6000, 9000)
            raw[t, 1, 0][cell] += 2000
        bg = np.where(fg, 0.05, 0.97)
        mg = np.where(fg, 0.9, 0.02)
        probs[t, :, 0] = np.stack([bg, mg, 1.0 - bg - mg])
    return raw, probs


def _edge_site(seed=1):
    """The second site, (EDGE_T, 2, 1, S, S) raw and (EDGE_T, 3, 1, S, S)
    probabilities: EDGE_CELLS, plus in every frame a cell of radius 11
    (about 380 px, under the size filter's 500) and an L of two 20 px bars
    along the bottom and right edges (about 7700 px, 10% of them left of
    its window)."""
    r = np.random.RandomState(seed)
    yy, xx = np.mgrid[:SIZE, :SIZE]
    raw = r.randint(28000, 31000, (EDGE_T, 2, 1, SIZE, SIZE)
                    ).astype(np.float64)
    probs = np.empty((EDGE_T, 3, 1, SIZE, SIZE))
    small = (yy - 110) ** 2 + (xx - 60) ** 2 < 11 ** 2
    ell = ((yy >= 232) & (yy < 252) & (xx < 252)) | \
        ((xx >= 232) & (xx < 252) & (yy >= 100) & (yy < 252))
    for t in range(EDGE_T):
        fg = small | ell
        for c0, drift, frames in EDGE_CELLS.values():
            if t in frames:
                cy, cx = np.rint(np.add(c0, np.multiply(drift, t)))
                fg |= (yy - cy) ** 2 + (xx - cx) ** 2 < RADIUS ** 2
        raw[t, 0, 0][fg] += r.randint(6000, 9000)
        raw[t, 1, 0][fg] += 2000
        bg = np.where(fg, 0.05, 0.97)
        mg = np.where(fg, 0.9, 0.02)
        probs[t, :, 0] = np.stack([bg, mg, 1.0 - bg - mg])
    return raw, probs


def _yaml(path, section, raw, supp, **extra):
    lines = [f"{section}:", f"  raw_dirs: ['{raw}']",
             f"  supp_dirs: ['{supp}']"]
    lines += [f"  {k}: {v}" for k, v in extra.items()]
    path.write_text("\n".join(lines) + "\n")
    return str(path)


# the stages between the probabilities and the latents, in graph order
CHAIN_STAGES = ["instance_segmentation", "extract_patches",
                "build_trajectories", "assemble", "trajectory_matching"]


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """The five stages on the same sites through both packages: the JAX
    package's run_pipeline, the port's stage CLIs and the port's
    run_pipeline CLI, each on its own copy of the inputs. Returns
    {"jax": (raw, supp), "port": (raw, supp), "pipeline": (raw, supp),
    "cfgs": {...}, "executed": {"jax": [...], "pipeline": [...]}}."""
    root = tmp_path_factory.mktemp("chain")
    sites = {SITE: _site(), EDGE_SITE: _edge_site()}
    dirs = {}
    for pkg in ("jax", "port", "pipeline"):
        raw, supp = root / f"{pkg}_raw", root / f"{pkg}_supp"
        raw.mkdir()
        for site, (raw_stack, probs) in sites.items():
            np.save(raw / f"{site}.npy", raw_stack)
            np.save(raw / f"{site}_NNProbabilities.npy", probs)
        dirs[pkg] = (str(raw), str(supp))

    raw, supp = dirs["jax"]
    mp = pytest.MonkeyPatch()
    try:
        # sklearn's DBSCAN (the JAX package's own fallback) and no
        # matplotlib figure: nothing of the JAX package is built here
        mp.setattr("dynamorph_tpu.native.dbscan._load", lambda: None)
        mp.setattr(jax_clustering, "save_instance_map",
                   lambda *a, **k: None)
        jcfg = JaxPC()
        jcfg.patch.window_size = WINDOW
        jcfg.latent_encoding = JaxLE(channels=[0, 1], input_size=INPUT)
        # the two sites are in two wells, so the JAX orchestrator's
        # per-well assemble and trajectory_matching are per-site calls
        executed = {"jax": jax_run_pipeline(raw, supp, sorted(sites), jcfg,
                                            stages=CHAIN_STAGES)}
    finally:
        mp.undo()

    raw, supp = dirs["port"]
    cfgs = root / "cfgs"
    cfgs.mkdir()
    seg = _yaml(cfgs / "seg.yml", "segmentation_inference", raw, supp)
    patch = _yaml(cfgs / "patch.yml", "patch", raw, supp,
                  window_size=WINDOW)
    vae = _yaml(cfgs / "vae.yml", "latent_encoding", raw, supp,
                input_size=INPUT)
    cpu = ["--device", "cpu"]
    run_segmentation.main(["-m", "instance_segmentation", "-c", seg, *cpu])
    run_patch.main(["-m", "extract_patches", "-c", patch, *cpu])
    run_patch.main(["-m", "build_trajectories", "-c", patch, *cpu])
    run_vae.main(["-m", "assemble", "-c", vae, *cpu])
    run_vae.main(["-m", "trajectory_matching", "-c", vae, *cpu])
    dirs["cfgs"] = {"seg": seg, "patch": patch, "vae": vae}

    raw, supp = dirs["pipeline"]
    pipe = _yaml(cfgs / "pipe.yml", "patch", raw, supp, window_size=WINDOW)
    with open(pipe, "a") as f:
        f.write(f"latent_encoding:\n  input_size: {INPUT}\n")
    dirs["cfgs"]["pipeline"] = pipe
    executed["pipeline"] = run_pipeline.main(
        ["-c", pipe, "--stages", *CHAIN_STAGES, *cpu])[raw]
    dirs["executed"] = executed
    return dirs


def _supp_site(dirs, pkg, site=SITE):
    return os.path.join(dirs[pkg][1], f"{site.split('-')[0]}-supps", site)


def _rel(path, dirs, pkg):
    """A patch name with its package's supp root cut off."""
    return os.path.relpath(path, dirs[pkg][1])


def _assert_same(a, b, path="obj"):
    """Deep equality of pickled structures: same types, same dtypes, arrays
    equal element for element."""
    assert type(a) is type(b), f"{path}: {type(a)} vs {type(b)}"
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, np.generic):
        assert a.dtype == b.dtype and a == b, path
    elif isinstance(a, dict):
        assert list(a.keys()) == list(b.keys()), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    else:
        assert a == b, path


@pytest.mark.parametrize("name", ["cell_positions.pkl",
                                  "cell_pixel_assignments.pkl",
                                  "cell_traj.pkl"])
def test_site_pickles_match_jax(chain, name):
    """cell_positions.pkl (re-saved by extract_patches with the kept
    cells), cell_pixel_assignments.pkl and cell_traj.pkl: same layout,
    dtypes and values; every planted cell found in every frame, each one
    trajectory of 12 points."""
    ours = load_pickle(os.path.join(_supp_site(chain, "port"), name))
    ref = load_pickle(os.path.join(_supp_site(chain, "jax"), name))
    _assert_same(ours, ref)
    if name == "cell_positions.pkl":
        assert sorted(ours) == list(range(T))
        assert all(len(ours[t]) == len(CENTERS0) for t in ours)
    if name == "cell_pixel_assignments.pkl":
        pos, lab = ours[0]
        assert pos.dtype == np.int64 and lab.dtype == np.int32
    if name == "cell_traj.pkl":
        trajectories, positions = ours
        assert len(trajectories) == len(CENTERS0)
        assert all(sorted(t) == list(range(T)) for t in trajectories)
        assert len(positions) == len(trajectories)


def _edge_cells(chain, pkg):
    """The edge site's kept cells, {t: {name: cell id}}, named by the
    EDGE_CELLS entry whose centre lies within 3 px."""
    cells = load_pickle(os.path.join(_supp_site(chain, pkg, EDGE_SITE),
                                     "cell_positions.pkl"))
    out = {}
    for t, frame in cells.items():
        out[t] = {}
        for cid, pos in frame:
            for name, (c0, drift, _) in EDGE_CELLS.items():
                if np.abs(pos - np.add(c0, np.multiply(drift, t))).max() \
                        <= 3:
                    out[t][name] = cid
    return cells, out


@pytest.mark.parametrize("name", ["cell_positions.pkl",
                                  "cell_pixel_assignments.pkl",
                                  "cell_traj.pkl"])
def test_edge_site_pickles_match_jax(chain, name):
    """The second site: the small and the L-shaped cells are clustered and
    dropped by the size and window filters, the late cell appears at t = 5,
    and the gaps of 2 and 3 frames are closed (the decoy, whose end lies
    within 100 px of the gap-2 cell's restart, stays apart) — as in the
    JAX package, artifact for artifact."""
    supp = _supp_site(chain, "port", EDGE_SITE)
    ours = load_pickle(os.path.join(supp, name))
    ref = load_pickle(os.path.join(_supp_site(chain, "jax", EDGE_SITE),
                                   name))
    _assert_same(ours, ref)
    cells, named = _edge_cells(chain, "port")
    if name == "cell_positions.pkl":
        assert sorted(cells) == list(range(EDGE_T))
        for t in range(EDGE_T):
            want = {n for n, (_, _, fr) in EDGE_CELLS.items() if t in fr}
            assert set(named[t]) == want and len(cells[t]) == len(want), t
    if name == "cell_pixel_assignments.pkl":
        _, lab = ours[0]
        kept = {cid for cid, _ in cells[0]}
        sizes = {int(c): int((lab == c).sum()) for c in np.unique(lab)
                 if c >= 0 and c not in kept}
        # the two dropped clusters: one under 500 px, one L in range
        assert sorted(s > 500 for s in sizes.values()) == [False, True]
    if name == "cell_traj.pkl":
        trajectories, _ = ours
        got = {}
        for traj in trajectories:
            names = {n for t, cid in traj.items()
                     for n, c in named[t].items() if c == cid}
            assert len(names) == 1, names
            got[names.pop()] = sorted(traj)
        assert got == {n: sorted(EDGE_CELLS[n][2])
                       for n in ("gap2", "gap3", "steady")}


@pytest.mark.parametrize("suffix", ["file_paths", "static_patches",
                                    "static_patches_relations",
                                    "static_patches_labels", "trajectories"])
def test_edge_well_artifacts_match_jax(chain, suffix):
    """The second site's well: the same dataset, relations, labels and
    trajectory index lists as the JAX package's."""
    well = EDGE_SITE.split("-")[0]
    ours = load_pickle(os.path.join(chain["port"][0],
                                    f"{well}_{suffix}.pkl"))
    ref = load_pickle(os.path.join(chain["jax"][0], f"{well}_{suffix}.pkl"))
    n = sum(len(fr) for _, _, fr in EDGE_CELLS.values())
    if suffix == "file_paths":
        ours = [_rel(f, chain, "port") for f in ours]
        ref = [_rel(f, chain, "jax") for f in ref]
        assert len(ours) == n
    if suffix == "static_patches":
        assert ours.shape == (n, 2, 1, INPUT, INPUT)
    if suffix == "trajectories":
        assert sorted(len(v) for v in ours.values()) == [12, 13, 14]
    _assert_same(ours, ref)


def test_skip_boundary_matches_jax(chain, tmp_path):
    """skip_boundary=True drops the top border cell from the stacks and
    from the re-saved cell_positions.pkl in the frames where its window
    crosses the edge, as the JAX package does."""
    raw = os.path.join(chain["port"][0], f"{SITE}.npy")
    seg = os.path.join(chain["port"][0], f"{SITE}_NNProbabilities.npy")
    folders = {}
    for pkg in ("jax", "port"):
        folder = tmp_path / pkg
        folder.mkdir()
        for name in ("cell_positions.pkl", "cell_pixel_assignments.pkl"):
            save_pickle(load_pickle(os.path.join(_supp_site(chain, "jax"),
                                                 name)), str(folder / name))
        folders[pkg] = str(folder)
    jax_patch.process_site_extract_patches(
        raw, seg, folders["jax"], window_size=WINDOW, channels=[0, 1],
        reload=False, skip_boundary=True)
    port_patch.process_site_extract_patches(
        raw, seg, folders["port"], window_size=WINDOW, channels=[0, 1],
        reload=False, skip_boundary=True, device="cpu")
    cells = load_pickle(os.path.join(folders["port"], "cell_positions.pkl"))
    _assert_same(cells, load_pickle(os.path.join(folders["jax"],
                                                 "cell_positions.pkl")))
    every = load_pickle(os.path.join(_supp_site(chain, "port"),
                                     "cell_positions.pkl"))
    half = WINDOW // 2
    for t in range(T):
        inside = [cid for cid, pos in every[t]
                  if (pos >= half).all() and (pos + half <= SIZE).all()]
        assert [cid for cid, _ in cells[t]] == inside
    assert len(cells[0]) == len(CENTERS0) - 1       # the top border cell
    ours = _stacks(chain, "port", folders["port"])
    ref = _stacks(chain, "jax", folders["jax"])
    for t in range(T):
        assert list(ours[t]) == list(ref[t])
        assert len(ours[t]) == len(cells[t])
        for k in ours[t]:
            for field in ("mat", "masked_mat"):
                np.testing.assert_array_equal(ours[t][k][field],
                                              ref[t][k][field])


def test_instance_map_png(chain):
    """segmentation_<t>.png decodes to the frame-sized label image: each
    kept cell in matplotlib's tab10[id % 10], everything else black."""
    supp = _supp_site(chain, "port")
    cells = load_pickle(os.path.join(supp, "cell_positions.pkl"))
    pix = load_pickle(os.path.join(supp, "cell_pixel_assignments.pkl"))
    tab10 = matplotlib.colormaps["tab10"]
    for t in (0, T - 1):
        got = cv2.imread(os.path.join(supp, f"segmentation_{t}.png"),
                         cv2.IMREAD_UNCHANGED)
        lab = labels_to_map((SIZE, SIZE), *pix[t])
        want = np.zeros((SIZE, SIZE, 3), np.uint8)
        for cid, _ in cells[t]:
            rgb = np.rint(np.array(tab10(cid % 10)[:3]) * 255)
            want[lab == cid] = rgb[::-1]                  # cv2 reads BGR
        assert got.shape == want.shape and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
        assert (got.sum(-1) > 0).sum() == sum(
            (lab == cid).sum() for cid, _ in cells[t])


def _stacks(chain, pkg, folder=None, ext=".pkl"):
    folder = folder or _supp_site(chain, pkg)
    out = {}
    for t in range(T):
        d = load_stack_any(os.path.join(folder, f"stacks_{t}{ext}"))
        out[t] = {os.path.relpath(k, folder): v for k, v in d.items()}
    return out


def test_stacks_match_jax(chain):
    """Every stacks_<t>.pkl: the same patch names in the same order and the
    same float64 arrays, bit for bit."""
    ours, ref = _stacks(chain, "port"), _stacks(chain, "jax")
    n = 0
    for t in range(T):
        assert list(ours[t]) == list(ref[t])
        for k in ours[t]:
            for field in ("mat", "masked_mat"):
                a, b = ours[t][k][field], ref[t][k][field]
                assert a.dtype == b.dtype == np.float64
                assert a.shape == (4, 1, WINDOW, WINDOW)
                np.testing.assert_array_equal(a, b, err_msg=f"{t} {k}")
            n += 1
    assert n == T * len(CENTERS0)
    # the border cell's window is filled at the frame edge and masked there
    cells = load_pickle(os.path.join(_supp_site(chain, "port"),
                                     "cell_positions.pkl"))
    cid, pos = min(cells[0], key=lambda c: c[1][0])
    assert pos[0] < WINDOW // 2
    m = ours[0][f"0_{cid}.h5"]
    edge = WINDOW // 2 - pos[0]
    assert (m["mat"][:2, 0, :edge] == 0).all()
    assert (m["masked_mat"][:2, 0, :edge] != 0).all()


def test_stacks_compact_match_jax(chain, tmp_path):
    """storage="compact": the port's stacks_<t>.npz equal the JAX
    package's, and hold the values of the pickles."""
    raw = os.path.join(chain["port"][0], f"{SITE}.npy")
    seg = os.path.join(chain["port"][0], f"{SITE}_NNProbabilities.npy")
    folders = {}
    for pkg in ("jax", "port"):
        folder = tmp_path / pkg
        folder.mkdir()
        for name in ("cell_positions.pkl", "cell_pixel_assignments.pkl"):
            save_pickle(load_pickle(os.path.join(_supp_site(chain, "jax"),
                                                 name)), str(folder / name))
        folders[pkg] = str(folder)
    jax_patch.process_site_extract_patches(
        raw, seg, folders["jax"], window_size=WINDOW, channels=[0, 1],
        reload=False, storage="compact")
    port_patch.process_site_extract_patches(
        raw, seg, folders["port"], window_size=WINDOW, channels=[0, 1],
        reload=False, storage="compact", device="cpu")
    assert sorted(os.listdir(folders["port"])) == \
        sorted(os.listdir(folders["jax"]))
    ours = _stacks(chain, "port", folders["port"], ".npz")
    ref = _stacks(chain, "jax", folders["jax"], ".npz")
    pickles = _stacks(chain, "port")
    for t in range(T):
        assert list(ours[t]) == list(ref[t]) == list(pickles[t])
        for k in ours[t]:
            for field in ("mat", "masked_mat"):
                a = ours[t][k][field]
                assert a.dtype == np.float32
                np.testing.assert_array_equal(a, ref[t][k][field])
                np.testing.assert_array_equal(a.astype(np.float64),
                                              pickles[t][k][field])


def test_extract_reload_skips_existing(chain, tmp_path):
    """reload=True keeps a frame whose stack loads, and rebuilds one that
    does not."""
    raw = os.path.join(chain["port"][0], f"{SITE}.npy")
    seg = os.path.join(chain["port"][0], f"{SITE}_NNProbabilities.npy")
    for name in ("cell_positions.pkl", "cell_pixel_assignments.pkl"):
        save_pickle(load_pickle(os.path.join(_supp_site(chain, "port"),
                                             name)), str(tmp_path / name))
    save_pickle({"kept": 1}, str(tmp_path / "stacks_0.pkl"))
    (tmp_path / "stacks_1.pkl").write_bytes(b"not a pickle")
    port_patch.process_site_extract_patches(
        raw, seg, str(tmp_path), window_size=WINDOW, channels=[0, 1],
        reload=True, device="cpu")
    assert load_pickle(str(tmp_path / "stacks_0.pkl")) == {"kept": 1}
    got = load_pickle(str(tmp_path / "stacks_1.pkl"))
    want = load_pickle(os.path.join(_supp_site(chain, "port"),
                                    "stacks_1.pkl"))
    assert [os.path.basename(k) for k in got] == \
        [os.path.basename(k) for k in want]


@pytest.mark.parametrize("suffix", ["file_paths", "static_patches",
                                    "static_patches_relations",
                                    "static_patches_labels", "trajectories"])
def test_well_artifacts_match_jax(chain, suffix):
    """The assembled well (file paths, static patches bit for bit,
    relations, labels) and the trajectory index lists."""
    ours = load_pickle(os.path.join(chain["port"][0],
                                    f"{WELL}_{suffix}.pkl"))
    ref = load_pickle(os.path.join(chain["jax"][0], f"{WELL}_{suffix}.pkl"))
    if suffix == "file_paths":
        ours = [_rel(f, chain, "port") for f in ours]
        ref = [_rel(f, chain, "jax") for f in ref]
        assert len(ours) == T * len(CENTERS0)
    if suffix == "static_patches":
        assert ours.shape == (T * len(CENTERS0), 2, 1, INPUT, INPUT)
    if suffix == "trajectories":
        assert len(ours) == len(CENTERS0)
        assert all(len(v) == T for v in ours.values())
    _assert_same(ours, ref)


def test_combine_dataset_matches_jax(chain, tmp_path):
    """combine_dataset over two wells (the site's well and a renamed copy)
    with masks: the same merged names, patches, masks and relations."""
    raw = chain["port"][0]
    fs = load_pickle(os.path.join(raw, f"{WELL}_file_paths.pkl"))
    data = load_pickle(os.path.join(raw, f"{WELL}_static_patches.pkl"))
    rel = load_pickle(os.path.join(raw,
                                   f"{WELL}_static_patches_relations.pkl"))
    names = []
    for i, well in enumerate((WELL, "A1")):
        prefix = str(tmp_path / well)
        wfs = [f.replace(f"{WELL}-supps", f"{well}-supps").replace(
            SITE, f"{well}-Site_0") for f in fs]
        save_pickle(wfs, prefix + "_file_paths.pkl")
        save_pickle(data + i, prefix + "_static_patches.pkl")
        save_pickle(data[:, :1] > 30000 + i,
                    prefix + "_static_patches_mask.pkl")
        save_pickle(rel, prefix + "_static_patches_relations.pkl")
        names.append(prefix)
    combine_dataset(names, str(tmp_path / "ours"))
    jax_patch_vae.combine_dataset(names, str(tmp_path / "ref"))
    for suffix in ("file_paths", "static_patches", "static_patches_mask",
                   "static_patches_relations"):
        ours = load_pickle(str(tmp_path / f"ours_{suffix}.pkl"))
        ref = load_pickle(str(tmp_path / f"ref_{suffix}.pkl"))
        _assert_same(ours, ref)
    assert len(load_pickle(str(tmp_path / "ours_file_paths.pkl"))) == \
        2 * len(fs)


def _artifacts(dirs, pkg):
    """Every artifact of the five stages under one package's dirs, keyed
    by its name with the package's roots cut off, paths inside it too."""
    raw, supp = dirs[pkg]
    out = {}
    for site in (SITE, EDGE_SITE):
        folder = _supp_site(dirs, pkg, site)
        for name in sorted(os.listdir(folder)):
            if name.endswith(".pkl"):
                data = load_pickle(os.path.join(folder, name))
                if name.startswith("stacks_"):
                    data = {os.path.relpath(k, supp): v
                            for k, v in data.items()}
                out[f"{site}/{name}"] = data
    for name in sorted(os.listdir(raw)):
        if name.endswith(".pkl"):
            data = load_pickle(os.path.join(raw, name))
            if name.endswith("_file_paths.pkl"):
                data = [os.path.relpath(f, supp) for f in data]
            out[name] = data
    return out


def test_run_pipeline_artifacts_match_jax(chain):
    """The port's run_pipeline (--stages instance_segmentation ...
    trajectory_matching, --device cpu) on its own copy of the inputs writes
    every artifact of the JAX package's run_pipeline, equal: the site
    pickles, every frame's stacks, the wells' static patches, file paths,
    relations, labels and trajectory lists."""
    ours, ref = _artifacts(chain, "pipeline"), _artifacts(chain, "jax")
    assert list(ours) == list(ref)
    n_stacks = sum(name.split("/")[-1].startswith("stacks_")
                   for name in ours)
    assert n_stacks == T + EDGE_T and len(ours) == n_stacks + 6 + 10
    for name in ours:
        _assert_same(ours[name], ref[name], name)


def test_run_pipeline_stage_lists_match_jax(chain, monkeypatch):
    """The executed stages, fresh (all five, as the JAX package's
    run_pipeline returns them) and resumed: extract_patches has no
    skip rule, so it runs again (here a stand-in that records the call);
    over the four stages that have one, both packages skip everything."""
    from dynamorph_tpu_torch.pipeline import orchestrator

    assert chain["executed"]["pipeline"] == chain["executed"]["jax"] == \
        CHAIN_STAGES
    pipe = chain["cfgs"]["pipeline"]
    raw = chain["pipeline"][0]
    extracted = []
    monkeypatch.setattr(orchestrator, "extract_patches",
                        lambda *a, **k: extracted.append(a[2]))
    again = run_pipeline.main(["-c", pipe, "--stages", *CHAIN_STAGES,
                               "--device", "cpu"])
    assert again == {raw: ["extract_patches"]}
    assert extracted == [[SITE, EDGE_SITE]]
    skippable = [s for s in CHAIN_STAGES if s != "extract_patches"]
    jcfg = JaxPC()
    jcfg.patch.window_size = WINDOW
    resumed = jax_run_pipeline(*chain["jax"], [SITE, EDGE_SITE], jcfg,
                               stages=skippable)
    ours = run_pipeline.main(["-c", pipe, "--stages", *skippable,
                              "--device", "cpu"])
    assert ours == {raw: resumed} and resumed == []


def test_run_pipeline_raises_without_card(chain):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_pipeline.main(["-c", chain["cfgs"]["pipeline"], "--stages",
                           "build_trajectories"])


def test_convert_storage_matches_jax(chain, tmp_path):
    """convert_storage --to compact, then --to pickle, over a copy of a
    site's stacks and its well's static patches and labels: the same .npz
    members and arrays as the JAX package's converter, the same pickles
    back, and the labels (no compact form) left alone."""
    import shutil

    from dynamorph_tpu.cli import convert_storage as jax_convert
    from dynamorph_tpu_torch.cli import convert_storage

    raw = chain["port"][0]
    for pkg in ("ours", "ref"):
        d = tmp_path / pkg
        d.mkdir()
        for name in ("stacks_0.pkl", "stacks_5.pkl"):
            shutil.copy(os.path.join(_supp_site(chain, "port"), name), d)
        for suffix in ("static_patches", "static_patches_labels"):
            shutil.copy(os.path.join(raw, f"{WELL}_{suffix}.pkl"), d)
    for to in ("compact", "pickle"):
        if to == "pickle":
            for pkg in ("ours", "ref"):
                for f in (tmp_path / pkg).glob("*.pkl"):
                    if "labels" not in f.name:
                        f.rename(f.with_suffix(".orig"))
        assert convert_storage.main(["--to", to, str(tmp_path / "ours")]) \
            == 0
        assert jax_convert.main(["--to", to, str(tmp_path / "ref")]) == 0
    names = sorted(os.listdir(tmp_path / "ref"))
    assert sorted(os.listdir(tmp_path / "ours")) == names
    assert len([n for n in names if n.endswith(".npz")]) == 3
    for name in names:
        a, b = tmp_path / "ours" / name, tmp_path / "ref" / name
        if name.endswith(".npz"):
            with np.load(a) as za, np.load(b) as zb:
                assert za.files == zb.files
                for m in za.files:
                    np.testing.assert_array_equal(za[m], zb[m])
        elif name.endswith(".pkl"):
            _assert_same(load_pickle(str(a)), load_pickle(str(b)), name)
    # the stacks come back as they were (float32-exact patch values)
    _assert_same(load_pickle(str(tmp_path / "ours" / "stacks_0.pkl")),
                 load_pickle(str(tmp_path / "ours" / "stacks_0.orig")))


def test_entry_points_raise_without_card(chain):
    """Without a card and without --device cpu, the new stages raise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfgs = chain["cfgs"]
    calls = [(run_segmentation, ["-m", "instance_segmentation", "-c",
                                 cfgs["seg"]]),
             (run_patch, ["-m", "extract_patches", "-c", cfgs["patch"]]),
             (run_patch, ["-m", "build_trajectories", "-c", cfgs["patch"]]),
             (run_vae, ["-m", "assemble", "-c", cfgs["vae"]]),
             (run_vae, ["-m", "trajectory_matching", "-c", cfgs["vae"]])]
    for cli, argv in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.main(argv)


# ---------------------------------------------------------------- ops


def test_extract_cell_patches_matches_jax():
    """The window, mask and fill program on one frame with cells at every
    border and a NaN-free fill: equal to the JAX program bit for bit."""
    import jax.numpy as jnp

    r = np.random.RandomState(3)
    raw = r.randint(0, 65535, (2, 96, 80)).astype(np.float32)
    labels = np.full((96, 80), -1, np.int32)
    yy, xx = np.mgrid[:96, :80]
    centers = np.array([[3, 40], [90, 5], [48, 77], [40, 30], [52, 44]])
    for i, (cy, cx) in enumerate(centers):
        labels[(yy - cy) ** 2 + (xx - cx) ** 2 < 81] = 10 + i
    ids = np.arange(10, 10 + len(centers), dtype=np.int32)
    bg = np.array([1234.5, 77.0], np.float32)
    ours = extract_cell_patches(torch.from_numpy(raw),
                                torch.from_numpy(labels),
                                torch.from_numpy(centers),
                                torch.from_numpy(ids), torch.from_numpy(bg),
                                window_size=32)
    ref = jax_patch_ops.extract_cell_patches(
        jnp.asarray(raw), jnp.asarray(labels),
        jnp.asarray(centers.astype(np.int32)), jnp.asarray(ids),
        jnp.asarray(bg), window_size=32)
    for k in ("mat", "masked_mat", "tm", "tm2"):
        a, b = ours[k].numpy(), np.asarray(ref[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert ours["tm2"].sum() > ours["tm"].sum() > 0


@pytest.mark.parametrize("count", ["even", "odd", "none"])
def test_median_background_matches_nanmedian(count):
    """The mean of the two middle values at an even count (where
    torch.median would take the lower), the middle one at an odd count,
    NaN with no background pixel: as np.nanmedian and jnp.nanmedian."""
    import jax.numpy as jnp

    r = np.random.RandomState(4)
    raw = r.randint(0, 1000, (2, 16, 16)).astype(np.float32)
    bg = r.rand(16, 16).astype(np.float32)
    n_bg = {"even": 40, "odd": 41, "none": 0}[count]
    bg.ravel()[:] = 0.5
    bg.ravel()[r.permutation(256)[:n_bg]] = 0.95
    ours = median_background(torch.from_numpy(raw),
                             torch.from_numpy(bg)).numpy()
    ref = np.asarray(jax_patch_ops.median_background(jnp.asarray(raw),
                                                     jnp.asarray(bg)))
    mask = bg > np.float32(0.9)
    want = np.array([np.median(raw[c][mask]) if n_bg else np.nan
                     for c in range(2)], np.float32)
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(ours, want)
    if count == "even":
        lower = torch.median(torch.from_numpy(raw[0][mask])).item()
        assert ours[0] != lower       # the two middle values differ here


@pytest.mark.parametrize("factor", [2, 3, 4])
def test_resize_chw_integer_factor_matches_cv2(factor):
    """At integer factors _resize_chw equals cv2.resize (the JAX
    package's _resize_chw) bit for bit on 2-channel patches (the
    pipeline's) of any float64 values, and on 1-channel ones of pipeline
    values (multiples of 0.5 below 2**16); 1-channel random values within
    RESIZE_RTOL_INT."""
    r = np.random.RandomState(factor)
    n = 96
    dst = (n // factor, n // factor)
    cases = [(r.rand(2, 1, n, n) * 1e3, 0.0),
             (r.randint(0, 2 ** 17, (2, 1, n, n)) / 2, 0.0),
             (r.randint(0, 2 ** 17, (1, n, n)) / 2, 0.0),
             (r.rand(1, n, n) * 1e3, RESIZE_RTOL_INT)]
    for dat, rtol in cases:
        ours, ref = _resize_chw(dat, dst), jax_patch_vae._resize_chw(dat, dst)
        assert ours.shape == ref.shape == dat.shape[:-2] + dst
        err = np.abs(ours - ref).max() / np.abs(ref).max()
        assert err <= rtol, (dat.shape, err)


@pytest.mark.parametrize("src,dst", [((64, 64), (40, 40)),
                                     ((50, 70), (128, 96))])
def test_resize_chw_non_integer_factor_matches_cv2(src, dst):
    """At other sizes (down and up, non-square) _resize_chw equals cv2 bit
    for bit on 2-channel patches of random float64 values; 1-channel
    patches of pipeline values are held to RESIZE_RTOL (cv2 5.0 samples
    them at float64 positions, OpenCV's generic path at float32 ones)."""
    r = np.random.RandomState(7)
    dat = r.rand(2, 1, *src) * 1e3
    ours = _resize_chw(dat, dst)
    np.testing.assert_array_equal(ours, jax_patch_vae._resize_chw(dat, dst))
    assert ours.shape == (2, 1, dst[1], dst[0])
    dat = r.randint(0, 2 ** 17, (1,) + src) / 2
    ref = jax_patch_vae._resize_chw(dat, dst)
    err = np.abs(_resize_chw(dat, dst) - ref).max() / np.abs(ref).max()
    assert err <= RESIZE_RTOL, err


# ---------------------------------------------------------------- native


@pytest.mark.parametrize("case", ["blobs", "random"])
def test_grid_dbscan_matches_sklearn(case):
    """The port's native grid DBSCAN gives sklearn's labels exactly."""
    from sklearn.cluster import DBSCAN

    from dynamorph_tpu_torch.native.dbscan import grid_dbscan

    r = np.random.RandomState(5)
    if case == "blobs":
        img = np.zeros((120, 140), bool)
        yy, xx = np.mgrid[:120, :140]
        for cy, cx, rad in ((30, 30, 14), (32, 58, 12), (90, 100, 20),
                            (95, 20, 6)):
            img |= (yy - cy) ** 2 + (xx - cx) ** 2 < rad ** 2
        img |= r.rand(120, 140) < 0.02
        pts, eps, ms = np.argwhere(img), 10, 250
    else:
        img = r.rand(60, 60) < 0.3
        pts, eps, ms = np.argwhere(img), 2.5, 6
    ours = grid_dbscan(pts, eps=eps, min_samples=ms, shape=img.shape)
    ref = DBSCAN(eps=eps, min_samples=ms).fit(pts).labels_
    assert ours.dtype == np.int32
    np.testing.assert_array_equal(ours, ref)
    assert len(np.unique(ours)) > 2


@pytest.mark.parametrize("threads", [1, 3])
def test_cluster_threads_give_the_same_labels(threads):
    """``threads`` splits the native solver's core test: on the first frame
    of the crowded site (a disk of radius 14 around each of its 144 cells,
    and scattered noise pixels) the labels and the kept cells are the same
    for 1 and 3 threads as for the default count."""
    from dynamorph_tpu_torch.native.dbscan import grid_dbscan
    from dynamorph_tpu_torch.track.clustering import \
        cluster_foreground_positions

    positions, _ = _crowded_site(t_len=1)
    shape = (2200, 2200)
    r = np.random.RandomState(9)
    yy, xx = np.mgrid[-14:15, -14:15]
    disk = np.argwhere(yy ** 2 + xx ** 2 < 196) - 14
    fg = np.zeros(shape, bool)
    for _, centre in positions[0]:
        pts = disk + centre
        fg[pts[:, 0], pts[:, 1]] = True
    fg |= r.rand(*shape) < 2e-4
    pts = np.argwhere(fg)
    labels = grid_dbscan(pts, eps=10, min_samples=250, shape=shape,
                         threads=threads)
    np.testing.assert_array_equal(
        labels, grid_dbscan(pts, eps=10, min_samples=250, shape=shape))
    assert len(np.unique(labels[labels >= 0])) == 144
    ours = cluster_foreground_positions(pts, shape, threads=threads)
    _assert_same(ours, cluster_foreground_positions(pts, shape))
    assert len(ours[0]) == 144


def test_grid_dbscan_refuses_bad_points():
    """Duplicates and points off the grid raise; nothing falls back."""
    from dynamorph_tpu_torch.native.dbscan import grid_dbscan

    with pytest.raises(ValueError, match="duplicate"):
        grid_dbscan(np.array([[1, 1], [1, 1], [2, 2]]), 2, 2, shape=(4, 4))
    with pytest.raises(ValueError, match="outside"):
        grid_dbscan(np.array([[1, 1], [5, 5]]), 2, 2, shape=(4, 4))


def test_solve_lap_native_matches_scipy():
    """A large finite instance goes to the native solver, with scipy's
    optimum; a non-finite one goes to scipy."""
    from scipy.optimize import linear_sum_assignment

    from dynamorph_tpu_torch.track.matching import NATIVE_LAP_MIN_N, solve_lap

    r = np.random.RandomState(6)
    cost = r.rand(NATIVE_LAP_MIN_N, NATIVE_LAP_MIN_N)
    rows, cols = solve_lap(cost)
    ref_rows, ref_cols = linear_sum_assignment(cost)
    np.testing.assert_array_equal(cols, ref_cols)
    cost[0, 0] = np.inf
    np.testing.assert_array_equal(solve_lap(cost)[1],
                                  linear_sum_assignment(cost)[1])


def _crowded_site(n_side=12, t_len=12, seed=8):
    """Tracking inputs of a crowded site: n_side**2 cells (144) on a
    jittered 170 px grid, each drifting by its own integer step a frame;
    cells 0-9 miss frame 5 (gaps of 2), cells 10-14 frames 5 and 6 (gaps
    of 3), so that every frame pair and the gap-closing LAP reach
    NATIVE_LAP_MIN_N. Returns (cell_positions, cell_pixel_assignments) in
    the instance-segmentation layout."""
    r = np.random.RandomState(seed)
    grid = np.stack(np.meshgrid(np.arange(n_side), np.arange(n_side),
                                indexing="ij"), -1).reshape(-1, 2)
    base = 100 + grid * 170 + r.randint(-20, 21, grid.shape)
    step = r.randint(-3, 4, grid.shape)
    sizes = r.randint(800, 3000, len(grid))
    missing = {c: {5} for c in range(10)}
    missing.update({c: {5, 6} for c in range(10, 15)})
    positions, pixels = {}, {}
    for t in range(t_len):
        ids = [c for c in range(len(grid)) if t not in missing.get(c, ())]
        positions[t] = [(c, (base[c] + step[c] * t).astype(np.int64))
                        for c in ids]
        labels = np.repeat(np.array(ids, np.int32), sizes[ids])
        pixels[t] = (np.zeros((len(labels), 2), np.int64), labels)
    return positions, pixels


def test_tracking_native_lap_matches_jax(monkeypatch):
    """A site crowded enough for the native JV solver (frame pairs of 144
    cells, 159 trajectory pieces to connect): the port's trajectories equal
    the JAX package's. The JAX side solves with scipy, its own fallback, so
    that no in-place native build of the JAX package starts here; the
    optimum is unique, so both solvers give it."""
    from dynamorph_tpu.native import lap as jax_lap
    from dynamorph_tpu.track import matching as jax_matching
    from dynamorph_tpu_torch.native import lap as port_lap
    from dynamorph_tpu_torch.track import matching as port_matching

    sizes = []
    solve = port_lap.lap_solve

    def counted(cost):
        sizes.append(cost.shape[0])
        return solve(cost)

    monkeypatch.setattr(port_lap, "lap_solve", counted)
    monkeypatch.setattr(jax_lap, "native_lap_available", lambda: False)
    positions, pixels = _crowded_site()
    ours = port_matching.build_site_trajectories(positions, pixels)
    ref = jax_matching.build_site_trajectories(positions, pixels)
    _assert_same(ours, ref)
    # all 11 frame pairs (268 to 288 rows) and the gap-closing LAP
    # (2 x 159 pieces)
    assert len(sizes) == 12 and min(sizes) >= port_matching.NATIVE_LAP_MIN_N
    assert sizes[-1] == 318
    trajectories, _ = ours
    # the gaps of 2 are closed (11 points); the cells with gaps of 3 are
    # 10 points long and fall under min_length
    assert sorted(len(t) for t in trajectories) == [11] * 10 + [12] * 129
    assert sorted(t[0] for t in trajectories if len(t) == 11) == \
        list(range(10))


def test_tracking_raises_when_native_build_fails(monkeypatch):
    """A native build that fails propagates out of the tracking stage: the
    site does not degrade to empty trajectories."""
    from dynamorph_tpu_torch import native
    from dynamorph_tpu_torch.track.matching import build_site_trajectories

    def broken(name):
        raise native.NativeError(f"native build of {name} failed: g++ "
                                 "exited 1")

    native.load.cache_clear()
    monkeypatch.setattr(native, "build", broken)
    try:
        with pytest.raises(native.NativeError, match="lap failed"):
            build_site_trajectories(*_crowded_site(t_len=2))
    finally:
        native.load.cache_clear()


def test_pickles_load_without_the_port(chain):
    """The port's site pickles hold only numpy and builtin types, so the
    JAX package (or plain pickle) reads them."""
    path = os.path.join(_supp_site(chain, "port"), "cell_positions.pkl")
    with open(path, "rb") as f:
        data = f.read()
    assert b"dynamorph_tpu_torch" not in data and b"torch" not in data
    assert pickle.loads(data).keys() == set(range(T))


def test_run_vae_config_forces_mat(chain):
    """run_vae -m assemble stacks the unmasked "mat" patches whatever
    patch_type says (reference run_VAE.py:21)."""
    cfg = load_config(chain["cfgs"]["vae"])
    assert cfg.latent_encoding.patch_type == "masked_mat"
    raw = chain["port"][0]
    data = load_pickle(os.path.join(raw, f"{WELL}_static_patches.pkl"))
    fs = load_pickle(os.path.join(raw, f"{WELL}_file_paths.pkl"))
    folder = os.path.dirname(fs[0])
    t, cid = os.path.basename(fs[0])[:-3].split("_")
    stack = load_pickle(os.path.join(folder, f"stacks_{t}.pkl"))
    mat = stack[fs[0]]["mat"][:2]
    np.testing.assert_array_equal(data[0], _resize_chw(mat, (INPUT, INPUT)))


# -- Slice H: the long-axis-aligned extraction --------------------------

def _ellipse_scene(seed=0):
    """``tests/test_aux.py:69-139``'s scene: one 512 x 512 frame of 2
    channels, float64 intensities near 30000, three 24 x 12 elliptical
    cells (here at seeded angles) 10000 brighter, the probabilities made
    from their masks; the instance pickles straight from the masks."""
    r = np.random.RandomState(seed)
    size = 512
    yy, xx = np.mgrid[:size, :size]
    img = r.rand(2, 1, size, size) * 1000 + 30000
    labels = np.full((size, size), -1)
    centers = r.randint(120, size - 120, size=(3, 2))
    for cid, ((cy, cx), t) in enumerate(zip(centers, r.rand(3) * np.pi)):
        u = (yy - cy) * np.cos(t) + (xx - cx) * np.sin(t)
        v = -(yy - cy) * np.sin(t) + (xx - cx) * np.cos(t)
        m = (u / 24.0) ** 2 + (v / 12.0) ** 2 < 1
        labels[m & (labels < 0)] = cid
        img[:, 0][:, m] += 10000
    fg = labels >= 0
    bg = np.where(fg, 0.05, 0.97)
    mg = np.where(fg, 0.9, 0.02)
    seg = np.stack([bg, mg, 1 - bg - mg])[:, None]
    pix = np.argwhere(fg)
    positions = {0: [(np.int32(c), np.array(ctr)) for c, ctr in
                     enumerate(centers)]}
    assignments = {0: (pix, labels[fg].astype(np.int32))}
    return img[None], seg[None], positions, assignments


def test_align_axis_extraction_matches_jax(tmp_path):
    """``process_site_extract_patches_align_axis`` (window 256, enlarged
    to 364) on the scene: ``stacks_rotated_0.pkl`` equal to the JAX
    package's, keys and arrays bit for bit (the port's warps are cv2's
    arithmetics: uint8 masks, 2-channel uint16 windows)."""
    images, segs, positions, assignments = _ellipse_scene()
    np.save(tmp_path / "s.npy", images)
    np.save(tmp_path / "s_NNProbabilities.npy", segs)
    for pkg in ("jax", "port"):
        d = tmp_path / pkg
        d.mkdir()
        save_pickle(positions, str(d / "cell_positions.pkl"))
        save_pickle(assignments, str(d / "cell_pixel_assignments.pkl"))
    args = (str(tmp_path / "s.npy"), str(tmp_path / "s_NNProbabilities.npy"))
    jax_patch.process_site_extract_patches_align_axis(
        *args, str(tmp_path / "jax"), window_size=256)
    port_patch.process_site_extract_patches_align_axis(
        *args, str(tmp_path / "port"), window_size=256, device="cpu")
    want = load_pickle(str(tmp_path / "jax" / "stacks_rotated_0.pkl"))
    got = load_pickle(str(tmp_path / "port" / "stacks_rotated_0.pkl"))
    assert [os.path.basename(k) for k in got] == \
        [os.path.basename(k) for k in want] == ["0_0.h5", "0_1.h5", "0_2.h5"]
    for kg, kw in zip(got, want):
        for field in ("mat", "masked_mat"):
            assert got[kg][field].dtype == np.float64
            assert got[kg][field].shape == (4, 1, 256, 256)
            np.testing.assert_array_equal(got[kg][field], want[kw][field])
        # the long axis lies along x after the rotation
        tm = got[kg]["mat"][2, 0]
        ys, xs = np.nonzero(tm)
        assert np.ptp(xs) > np.ptp(ys) + 10


@pytest.mark.parametrize("seed", range(4))
def test_get_cell_rect_angle_matches_jax(seed):
    """The long-axis angle of cell masks (ellipses at seeded angles, near
    squares, a mask with two components and a hole) equals the JAX
    package's, which reads cv2's minAreaRect; a failed native build
    propagates."""
    r = np.random.RandomState(40 + seed)
    yy, xx = np.mgrid[:96, :96]
    for _ in range(6):
        t, a = r.rand() * np.pi, 8 + 20 * r.rand()
        b = a * (0.3 + 0.7 * r.rand()) if seed != 3 else a * 1.0001
        u = (yy - 48) * np.cos(t) + (xx - 48) * np.sin(t)
        v = -(yy - 48) * np.sin(t) + (xx - 48) * np.cos(t)
        d = (u / a) ** 2 + (v / b) ** 2
        tm = (d < 1).astype(np.float32)
        if seed == 2:
            tm[d < 0.2] = 0
            tm[5:9, 80:90] = 1
        assert abs(port_patch.get_cell_rect_angle(tm)
                   - jax_patch.get_cell_rect_angle(tm)) <= 1e-4


def test_contours_build_failure_propagates(monkeypatch):
    """A failed g++ build of contours.cpp raises NativeError out of the
    long-axis angle; nothing falls back."""
    from dynamorph_tpu_torch import native

    def broken(name):
        raise native.NativeError(f"native build of {name} failed: g++ "
                                 "exited 1")

    native.load.cache_clear()
    monkeypatch.setattr(native, "build", broken)
    try:
        with pytest.raises(native.NativeError, match="contours failed"):
            port_patch.get_cell_rect_angle(np.ones((8, 8), np.float32))
    finally:
        native.load.cache_clear()
