"""Patch extraction on the card against the port's CPU path: the window,
mask and fill program (``ops/patch.py::extract_cell_patches``) and the
background median on a full 2048 x 2048 frame with 30 cells, some at the
border, and the ``extract_patches`` stage on a small site. The masks are
0/1 and the fill multiplies by 0 or 1, so card and CPU must agree bit for
bit; any difference is a bug, not rounding.

This file imports neither jax nor the JAX package, so it also runs on a GPU
host without them: ``python -m pytest --noconftest
tests/test_torch_patch_cuda.py``. Without a card every test skips.
"""
import os

import numpy as np
import pytest
import torch

from dynamorph_tpu_torch.io.pickles import load_pickle, save_pickle
from dynamorph_tpu_torch.ops.patch import (extract_cell_patches,
                                           median_background)
from dynamorph_tpu_torch.pipeline.patch import process_site_extract_patches

FRAME = 2048
WINDOW = 256
N_CELLS = 30


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: compares the card with the CPU")
    return torch.device("cuda")


def _frame(seed, size=FRAME, n_cells=N_CELLS):
    """(raw (2, S, S) float32 of uint16 values, labels (S, S) int32 with -1
    off the cells, centres (N, 2), ids (N,), background probability
    (S, S) float32). Disk cells of radius 15-35 at least 25 px apart, the
    first four within half a window of each edge."""
    r = np.random.RandomState(seed)
    yy, xx = np.mgrid[:size, :size]
    centers, radii = [], []
    edges = [(40, size // 2), (size - 40, size // 3),
             (size // 2, 30), (size // 3, size - 50)]
    while len(centers) < n_cells:
        c = np.array(edges[len(centers)] if len(centers) < len(edges)
                     else r.randint(0, size, 2))
        rad = r.randint(15, 36)
        if all(np.linalg.norm(c - o) >= rad + ro + 25
               for o, ro in zip(centers, radii)):
            centers.append(c)
            radii.append(rad)
    labels = np.full((size, size), -1, np.int32)
    raw = r.randint(28000, 31000, (2, size, size)).astype(np.float32)
    for i, (c, rad) in enumerate(zip(centers, radii)):
        cell = (yy - c[0]) ** 2 + (xx - c[1]) ** 2 < rad ** 2
        labels[cell] = 3 * i + 1
        raw[0][cell] += r.randint(5000, 9000)
    bg = np.where(labels >= 0, 0.05, 0.97).astype(np.float32)
    ids = np.arange(len(centers), dtype=np.int32) * 3 + 1
    return raw, labels, np.array(centers), ids, bg


@pytest.mark.cuda
def test_extract_cell_patches_card_vs_cpu(cuda):
    raw, labels, centers, ids, bg = _frame(0)
    fill = median_background(torch.from_numpy(raw), torch.from_numpy(bg))
    args = [torch.from_numpy(a) for a in (raw, labels, centers, ids)]
    cpu = extract_cell_patches(*args, fill, window_size=WINDOW)
    card = extract_cell_patches(*[a.to(cuda) for a in args], fill.to(cuda),
                                window_size=WINDOW)
    for k in ("mat", "masked_mat", "tm", "tm2"):
        a, b = card[k].cpu().numpy(), cpu[k].numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert cpu["mat"].shape == (N_CELLS, 2, WINDOW, WINDOW)
    # border cells: the window runs off the frame, zero-filled in mat and
    # background-filled in masked_mat
    assert (cpu["mat"][0, :, :88] == 0).all()
    assert torch.equal(cpu["masked_mat"][0, :, :88],
                       fill[:, None, None].expand(2, 88, WINDOW))


@pytest.mark.cuda
@pytest.mark.parametrize("parity", ["even", "odd"])
def test_median_background_card_vs_cpu(cuda, parity):
    """The median of the background pixels (an even count: the mean of the
    two middle values) on the card equals the CPU's and numpy's."""
    raw, labels, _, _, bg = _frame(1)
    n_bg = int((bg > np.float32(0.9)).sum())
    if (n_bg % 2 == 0) != (parity == "even"):
        idx = np.argwhere(bg > 0.9)[0]
        bg[idx[0], idx[1]] = 0.05
    mask = bg > np.float32(0.9)
    assert (mask.sum() % 2 == 0) == (parity == "even")
    cpu = median_background(torch.from_numpy(raw), torch.from_numpy(bg))
    card = median_background(torch.from_numpy(raw).to(cuda),
                             torch.from_numpy(bg).to(cuda))
    want = np.array([np.median(raw[c][mask]) for c in range(2)], np.float32)
    np.testing.assert_array_equal(card.cpu().numpy(), cpu.numpy())
    np.testing.assert_array_equal(cpu.numpy(), want)


@pytest.mark.cuda
def test_extract_patches_stage_card_vs_cpu(cuda, tmp_path):
    """process_site_extract_patches on a 2-frame 512 x 512 site: the card's
    stacks_<t>.pkl equal the CPU's, key for key and array for array."""
    frames = [_frame(2 + t, size=512, n_cells=6) for t in range(2)]
    site = tmp_path / "site.npy"
    seg = tmp_path / "site_NNProbabilities.npy"
    np.save(site, np.stack([f[0][:, None] for f in frames]).astype(
        np.float64))
    probs = [np.stack([f[4], 0.9 * (1 - f[4]), 0.1 * (1 - f[4])])
             for f in frames]
    np.save(seg, np.stack(probs)[:, :, None].astype(np.float64))
    folders = {}
    for dev in ("cpu", "cuda"):
        folder = tmp_path / dev
        folder.mkdir()
        positions, assignments = {}, {}
        for t, (_, labels, centers, ids, _) in enumerate(frames):
            positions[t] = [(np.int32(i), c) for i, c in zip(ids, centers)]
            pix = np.argwhere(labels >= 0)
            assignments[t] = (pix, labels[pix[:, 0], pix[:, 1]])
        save_pickle(positions, str(folder / "cell_positions.pkl"))
        save_pickle(assignments, str(folder / "cell_pixel_assignments.pkl"))
        process_site_extract_patches(str(site), str(seg), str(folder),
                                     window_size=WINDOW, channels=[0, 1],
                                     reload=False, device=dev)
        folders[dev] = folder
    for t in range(2):
        card = load_pickle(str(folders["cuda"] / f"stacks_{t}.pkl"))
        cpu = load_pickle(str(folders["cpu"] / f"stacks_{t}.pkl"))
        assert [os.path.basename(k) for k in card] == \
            [os.path.basename(k) for k in cpu]
        assert len(cpu) == 6
        for kc, kg in zip(cpu, card):
            for field in ("mat", "masked_mat"):
                np.testing.assert_array_equal(card[kg][field],
                                              cpu[kc][field])
