"""``analysis/kaze.py`` and ``analysis.morphology.extract_features``
against OpenCV's own KAZE (``cv2.KAZE_create()``), where the installed cv2
has it: opencv 4.x has, opencv-python 5.0 has not (this file then skips).
It imports no jax, so it runs on the card's machine, whose cv2 is 4.13.0
(``tools/probe_cv2.py``):

    python -m pytest --noconftest -q tests/test_torch_kaze_oracle.py

The images (``oracle_images``): seeded 128 x 128 uint8 scenes of planted
Gaussian blobs, textured cells (disks with noise and a gradient), the
structured image of ``tests/test_aux.py``'s KAZE check, and channel slices
of ``chip_smoke.blob_patches`` (phase 4's well) through the
``astype("uint8")`` that ``extract_features`` applies. The port runs on the
card where there is one, else on the CPU.

Limits (ROADMAP queue 1, slice K): each of cv2's 32 strongest keypoints an
image is matched one to one with a port keypoint within ``PT_TOL`` px in
position, ``SIZE_RTOL`` in size and ``ANGLE_TOL`` rad in angle; at most
``UNMATCHED_MAX`` of them, pooled over the images, go unmatched; the
matched descriptors lie within ``DESC_TOL`` in L2. A keypoint goes
unmatched where the two sides round apart at a near tie: two orientation
windows of equal sums on a symmetric scene, or two responses at the 32nd
place. ``extract_features``
is held to the same limits row by row. Each test prints what it measured.
"""
import numpy as np
import pytest
import torch

from dynamorph_tpu_torch.analysis import kaze
from dynamorph_tpu_torch.analysis.morphology import extract_features

cv2 = pytest.importorskip("cv2")

PT_TOL = 0.5
SIZE_RTOL = 0.05
ANGLE_TOL = 0.1
UNMATCHED_MAX = 0.05
DESC_TOL = 0.05
TOP = 32


def _device():
    return "cuda" if torch.cuda.is_available() else "cpu"


def _need_kaze():
    if not hasattr(cv2, "KAZE_create"):
        pytest.skip(f"cv2 {cv2.__version__} has no KAZE_create")


def oracle_images():
    """[(name, (128, 128) uint8)]: at least 8 seeded scenes."""
    rng = np.random.RandomState(1234)
    yy, xx = np.mgrid[:128, :128].astype(np.float64)
    out = []
    for k in range(3):                                   # planted blobs
        img = np.full((128, 128), 20.0)
        for _ in range(6):
            cy, cx = rng.uniform(16, 112, 2)
            s = rng.uniform(2.5, 9.0)
            img += rng.uniform(80, 200) * np.exp(
                -((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s))
        out.append((f"blobs{k}", np.clip(img, 0, 255).astype(np.uint8)))
    for k in range(3):                                   # textured cells
        img = 30 + 0.3 * xx + rng.normal(0, 6, (128, 128))
        for _ in range(4):
            cy, cx = rng.uniform(20, 108, 2)
            r = rng.uniform(8, 18)
            inside = (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
            img[inside] += 90 + rng.normal(0, 25, inside.sum())
        out.append((f"cells{k}", np.clip(img, 0, 255).astype(np.uint8)))
    img = np.zeros((128, 128))                           # tests/test_aux.py
    for cy, cx in [(30, 40), (80, 90), (60, 30), (100, 50)]:
        img += 200 * np.exp(-(((yy - cy) ** 2 + (xx - cx) ** 2) / 80))
    out.append(("test_aux", img.astype("uint8")))
    import chip_smoke
    well = chip_smoke.blob_patches(np.random.RandomState(chip_smoke.SEED), 2)
    for i in range(2):
        for c in range(well.shape[1]):
            out.append((f"well{i}_{c}", well[i, c].astype("uint8")))
    return out


def cv2_top(img):
    """cv2's detect, the stable sort by -response, the top ``TOP``, and
    compute: (keypoints, descriptors) as extract_features takes them."""
    alg = cv2.KAZE_create()
    kps = sorted(alg.detect(img), key=lambda k: -k.response)[:TOP]
    kps, dsc = alg.compute(img, kps)
    return kps, dsc


def match(cv_kps, port_kp):
    """One-to-one: each cv2 keypoint, in order, takes the nearest unused
    port keypoint within PT_TOL in position, SIZE_RTOL in size and
    ANGLE_TOL in angle (both sides' angles as ``compute`` gives them).
    Returns [(i_cv, i_port)] and the worst position, size and angle
    errors of the pairs."""
    used, pairs, worst = set(), [], [0.0, 0.0, 0.0]
    for i, k in enumerate(cv_kps):
        d = np.hypot(port_kp.pt[:, 0] - k.pt[0], port_kp.pt[:, 1] - k.pt[1])
        rs = np.abs(port_kp.size - k.size) / k.size
        da = angle_diff(k.angle, port_kp.angle)
        ok = [j for j in np.argsort(d, kind="stable")
              if d[j] <= PT_TOL and rs[j] <= SIZE_RTOL and da[j] <= ANGLE_TOL
              and j not in used]
        if ok:
            j = ok[0]
            used.add(j)
            pairs.append((i, j))
            worst = [max(worst[0], d[j]), max(worst[1], rs[j]),
                     max(worst[2], da[j])]
    return pairs, worst


def angle_diff(a_deg, b_deg):
    d = np.deg2rad((np.asarray(a_deg, np.float64) - b_deg) % 360.0)
    return np.minimum(d, 2 * np.pi - d)


def compare(images, device):
    """Pooled over ``images``: cv2's keypoint count, the matched count,
    and the worst position, size, angle and descriptor errors of the
    matched pairs."""
    port = kaze.describe(*_detected(images, device))
    n_cv = n_matched = 0
    worst = dict(pt=0.0, size=0.0, angle=0.0, desc=0.0)
    for (_, img), (kp, desc) in zip(images, port):
        cv_kps, cv_desc = cv2_top(img)
        pairs, (pt, size, angle) = match(cv_kps, kp)
        n_cv += len(cv_kps)
        n_matched += len(pairs)
        worst["pt"] = max(worst["pt"], float(pt))
        worst["size"] = max(worst["size"], float(size))
        worst["angle"] = max(worst["angle"], float(angle))
        for i, j in pairs:
            worst["desc"] = max(worst["desc"], float(np.linalg.norm(
                cv_desc[i] - desc[j])))
    return n_cv, n_matched, worst


def _detected(images, device):
    stack = torch.from_numpy(np.stack([im for _, im in images])).to(device)
    ss = kaze.scale_space(stack)
    return ss, kaze.detect(ss)


def cv2_extract_features(x, vector_size=32):
    """``dynamorph_tpu.analysis.morphology.extract_features`` as written
    (the card's machine has no jax to import it from)."""
    x = x.astype("uint8")
    try:
        dscs = []
        alg = cv2.KAZE_create()
        for x_slice in x:
            kps = alg.detect(x_slice)
            kps = sorted(kps, key=lambda k: -k.response)[:vector_size]
            kps, dsc = alg.compute(x_slice, kps)
            if dsc is None:
                dsc = np.zeros((0,))
            dsc = dsc.flatten()
            needed = vector_size * 64
            if dsc.size < needed:
                dsc = np.concatenate([dsc, np.zeros(needed - dsc.size)])
            dscs.append(dsc)
        return np.stack(dscs, 0)
    except Exception as e:
        print("Error: " + str(e))
        return None


def test_keypoints_and_descriptors_match_cv2():
    _need_kaze()
    images = oracle_images()
    assert len(images) >= 8
    n_cv, n_matched, worst = compare(images, _device())
    unmatched = 1 - n_matched / n_cv
    print(f"cv2 {cv2.__version__}: {len(images)} images, {n_cv} cv2 "
          f"keypoints, unmatched {unmatched:.4f} (limit {UNMATCHED_MAX}); "
          f"worst matched: position {worst['pt']:.4g} px (limit {PT_TOL}), "
          f"size {worst['size']:.4g} (limit {SIZE_RTOL}), angle "
          f"{worst['angle']:.4g} rad (limit {ANGLE_TOL}), descriptor L2 "
          f"{worst['desc']:.4g} (limit {DESC_TOL})")
    assert unmatched <= UNMATCHED_MAX
    assert worst["desc"] <= DESC_TOL


def test_extract_features_matches_cv2():
    """The (C, 2048) rows: the layout, dtype and padding of the JAX
    function's, and each of cv2's keypoint rows beside the port's row of
    its matched keypoint within the limits."""
    _need_kaze()
    images = oracle_images()
    x = np.stack([im for _, im in images]).astype(np.float64)
    want = cv2_extract_features(x)
    got = extract_features(x, device=_device())
    assert got.shape == want.shape and got.dtype == want.dtype
    stack = torch.from_numpy(np.stack([im for _, im in images]))
    port = kaze.detect_and_compute(stack.to(_device()), top=TOP)
    n_cv = n_matched = 0
    worst = 0.0
    for c, ((_, img), (kp, _)) in enumerate(zip(images, port)):
        cv_kps, _ = cv2_top(img)
        pairs, _ = match(cv_kps, kp)
        n_cv += len(cv_kps)
        n_matched += len(pairs)
        rows_w, rows_g = want[c].reshape(TOP, 64), got[c].reshape(TOP, 64)
        for i, j in pairs:
            worst = max(worst, float(np.linalg.norm(rows_w[i] - rows_g[j])))
        assert not rows_g[len(kp):].any() and not rows_w[len(cv_kps):].any()
    unmatched = 1 - n_matched / n_cv
    print(f"extract_features: unmatched {unmatched:.4f} (limit "
          f"{UNMATCHED_MAX}), worst row L2 {worst:.4g} (limit {DESC_TOL})")
    assert unmatched <= UNMATCHED_MAX
    assert worst <= DESC_TOL
