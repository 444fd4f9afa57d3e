"""The port's preprocessing (raw TIFFs -> (T, 3, 1, Y, X) npy) against cv2
and the JAX package on the CPU.

The port reads TIFFs without cv2 (``dynamorph_tpu_torch/io/tiff.py``, LZW
in ``native/tiff_lzw.cpp``). Its pages must equal ``cv2.imread`` /
``cv2.imreadmulti`` with ``IMREAD_ANYDEPTH`` bit for bit, dtype included,
on uint8 and uint16 files, single- and multi-page: written by cv2 (LZW with
the horizontal predictor, several strips a page), by the JAX package's
writer (uncompressed), and by hand (big-endian, several strips). The stage
(``run_preproc --device cpu``) must write the npy stacks of the JAX
package's ``run_preprocess`` bit for bit, in the single-page (``z###``
files in position directories) and multipage layouts.
"""
import os
import struct
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from dynamorph_tpu.config.schema import PipelineConfig as JaxPC
from dynamorph_tpu.io.tiff import write_multipage_tiff as jax_write_tiff
from dynamorph_tpu.pipeline import preprocess as jax_pre
from dynamorph_tpu_torch.cli import run_preproc
from dynamorph_tpu_torch.io.images import read_image, read_multipage_tiff
from dynamorph_tpu_torch.io.tiff import (_ifds, read_tiff_pages,
                                         write_multipage_tiff)
from dynamorph_tpu_torch.pipeline import preprocess as port_pre

CHANNELS = ["Retardance", "Phase2D", "Brightfield"]


def _frames(dtype, n, h=300, w=53, seed=0):
    """Random frames with flat runs (so LZW finds repeats) and the dtype's
    extremes; 300 rows, so cv2 writes several strips a page."""
    r = np.random.RandomState(seed)
    top = np.iinfo(dtype).max
    a = r.randint(0, top + 1, (n, h, w)).astype(dtype)
    a[:, :10] = 17
    a[:, -1, :3] = (0, top, top - 1)
    return a


def _be_tiff(path, stack, rows_per_strip):
    """A big-endian uncompressed grayscale TIFF of several strips a page,
    written by hand."""
    t, h, w = stack.shape
    bits = stack.dtype.itemsize * 8
    n_strips = -(-h // rows_per_strip)
    out = bytearray(b"MM\x00\x2a\x00\x00\x00\x00")
    prev = 4
    for page in stack:
        data = page.astype(page.dtype.newbyteorder(">")).tobytes()
        row = w * stack.dtype.itemsize
        offsets, counts = [], []
        for s in range(n_strips):
            chunk = data[s * rows_per_strip * row:
                         (s + 1) * rows_per_strip * row]
            offsets.append(len(out))
            counts.append(len(chunk))
            out += chunk
        arrays = len(out)
        out += struct.pack(f">{n_strips}I", *offsets)
        out += struct.pack(f">{n_strips}I", *counts)
        if len(out) % 2:
            out += b"\x00"
        ifd = len(out)
        struct.pack_into(">I", out, prev, ifd)
        entries = [(256, 3, 1, w), (257, 3, 1, h), (258, 3, 1, bits),
                   (259, 3, 1, 1), (262, 3, 1, 1),
                   (273, 4, n_strips, arrays), (277, 3, 1, 1),
                   (278, 3, 1, rows_per_strip),
                   (279, 4, n_strips, arrays + 4 * n_strips)]
        out += struct.pack(">H", len(entries))
        for tag, typ, count, value in entries:
            if typ == 3 and count == 1:
                out += struct.pack(">HHIHH", tag, typ, count, value, 0)
            else:
                out += struct.pack(">HHII", tag, typ, count, value)
        prev = len(out)
        out += b"\x00\x00\x00\x00"
    with open(path, "wb") as f:
        f.write(bytes(out))


def _write(kind, path, stack):
    if kind == "cv2":
        if len(stack) == 1:
            assert cv2.imwrite(path, stack[0])
        else:
            assert cv2.imwritemulti(path, list(stack))
    elif kind == "jax_writer":
        jax_write_tiff(path, stack)
    else:
        _be_tiff(path, stack, rows_per_strip=16)


@pytest.mark.parametrize("pages", [1, 3])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("kind", ["cv2", "jax_writer", "big_endian"])
def test_reader_matches_cv2(tmp_path, kind, dtype, pages):
    """read_tiff_pages / read_multipage_tiff / read_image against
    cv2.imreadmulti and cv2.imread, bit for bit and dtype for dtype."""
    stack = _frames(dtype, pages)
    path = str(tmp_path / "a.tif")
    _write(kind, path, stack)
    bo, ifds = _ifds(Path(path).read_bytes(), path)
    tags = ifds[0]
    if kind == "cv2":           # what cv2.imwrite writes: LZW + predictor
        assert tags[259] == (5,) and tags[317] == (2,) and bo == "<"
        assert len(tags[273]) > 1
    elif kind == "big_endian":
        assert bo == ">" and len(tags[273]) == 19
    else:
        assert tags[259] == (1,)
    ok, ref = cv2.imreadmulti(path, flags=cv2.IMREAD_ANYDEPTH)
    assert ok
    ours = read_tiff_pages(path)
    assert len(ours) == len(ref) == pages
    for a, b, want in zip(ours, ref, stack):
        assert a.dtype == b.dtype == dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, want)
    first = read_image(path)
    np.testing.assert_array_equal(first, cv2.imread(path,
                                                    cv2.IMREAD_ANYDEPTH))
    assert first.dtype == dtype
    np.testing.assert_array_equal(read_multipage_tiff(path), np.array(ref))


def test_port_writer_round_trip(tmp_path):
    """The port's copy of the writer writes what the JAX one writes."""
    stack = _frames(np.uint16, 2)
    write_multipage_tiff(str(tmp_path / "port.tif"), stack)
    jax_write_tiff(str(tmp_path / "jax.tif"), stack)
    assert (tmp_path / "port.tif").read_bytes() == \
        (tmp_path / "jax.tif").read_bytes()
    np.testing.assert_array_equal(
        read_multipage_tiff(str(tmp_path / "port.tif")), stack)


def _patched(src, dst, tag, value):
    """Copy a little-endian one-page TIFF, setting the low 16 bits of an
    inline tag value."""
    buf = bytearray(Path(src).read_bytes())
    ifd = struct.unpack_from("<I", buf, 4)[0]
    n = struct.unpack_from("<H", buf, ifd)[0]
    for i in range(n):
        at = ifd + 2 + 12 * i
        if struct.unpack_from("<H", buf, at)[0] == tag:
            struct.pack_into("<H", buf, at + 8, value)
    Path(dst).write_bytes(bytes(buf))


@pytest.mark.parametrize("case,match", [
    ("rgb", "SamplesPerPixel = 3"),
    ("packbits", "Compression = 32773"),
    ("float", "SampleFormat = 3"),
    ("bigtiff", "BigTIFF"),
    ("no_size", "no image size"),
    ("missing", "cannot be found"),
])
def test_reader_refuses_what_it_cannot_read(tmp_path, case, match):
    """An RGB page, another compression, another sample format, a BigTIFF,
    a zero width and a missing file raise an IOError that names the
    case."""
    path = str(tmp_path / "bad.tif")
    gray = str(tmp_path / "gray.tif")
    jax_write_tiff(gray, _frames(np.uint16, 1))
    if case == "rgb":
        jax_write_tiff(path, _frames(np.uint8, 3).transpose(1, 2, 0)[None])
    elif case == "packbits":
        _patched(gray, path, 259, 32773)
    elif case == "no_size":
        _patched(gray, path, 256, 0)
    elif case == "float":
        buf = bytearray(Path(gray).read_bytes())
        ifd = struct.unpack_from("<I", buf, 4)[0]
        n = struct.unpack_from("<H", buf, ifd)[0]
        # append SampleFormat = 3 (IEEE float) as an 11th entry
        struct.pack_into("<H", buf, ifd, n + 1)
        buf[ifd + 2 + 12 * n: ifd + 2 + 12 * n] = struct.pack(
            "<HHIHH", 339, 3, 1, 3, 0)
        Path(path).write_bytes(bytes(buf))
    elif case == "bigtiff":
        Path(path).write_bytes(b"II\x2b\x00\x08\x00\x00\x00" + bytes(16))
    else:
        path = str(tmp_path / "nothing.tif")
    with pytest.raises(IOError, match=match):
        read_image(path)


def _layout(root, multipage, pos_dir=True, sites=("C5-Site_0", "C5-Site_1"),
            t=3, seed=1):
    """Raw TIFFs of 2 sites written by cv2 (LZW): per position directory
    ``img_<chan>_t<ttt>_z005.tif`` single pages, or one multipage
    ``img_<chan>.tif`` a channel. Without ``pos_dir``: flat files named
    ``img_<chan>_t<ttt>_p<ppp>_z005.tif``."""
    r = np.random.RandomState(seed)
    for p, site in enumerate(sites):
        folder = root / site if pos_dir else root
        folder.mkdir(parents=True, exist_ok=True)
        for chan in CHANNELS:
            stack = r.randint(0, 65536, (t, 40, 36)).astype(np.uint16)
            stack[:, :8] = 300 + p
            if multipage:
                assert cv2.imwritemulti(str(folder / f"img_{chan}.tif"),
                                        list(stack))
            else:
                for i, frame in enumerate(stack):
                    name = f"img_{chan}_t{i:03d}_z005.tif" if pos_dir \
                        else f"img_{chan}_t{i:03d}_p{p:03d}_z005.tif"
                    assert cv2.imwrite(str(folder / name), frame)


@pytest.mark.parametrize("pos_dir,fov", [(True, "all"),
                                         (True, ["C5-Site_1", "B9"]),
                                         (False, "all"), (False, [1, 0])])
def test_discover_sites_matches_jax(tmp_path, pos_dir, fov):
    _layout(tmp_path, multipage=False, pos_dir=pos_dir, t=2)
    (tmp_path / "notes.txt").write_text("not an image")
    ours = port_pre.discover_sites(str(tmp_path), fov, pos_dir)
    ref = jax_pre.discover_sites(str(tmp_path), fov, pos_dir)
    assert ours == ref and list(ours) == list(ref) and len(ours) >= 1


@pytest.mark.parametrize("multipage", [False, True])
def test_run_preproc_matches_jax(tmp_path, multipage):
    """run_preproc --device cpu writes the JAX package's npy stacks bit for
    bit: float64 (T, 3, 1, Y, X), Phase2D in slot 0, Retardance in 1,
    Brightfield in 2."""
    src, ours, ref = tmp_path / "src", tmp_path / "ours", tmp_path / "ref"
    _layout(src, multipage)
    cfg = tmp_path / "cfg.yml"
    cfg.write_text(
        "preprocess:\n"
        f"  image_dirs: ['{src}']\n  target_dirs: ['{ours}']\n"
        f"  channels: {CHANNELS}\n  pos_dir: True\n"
        f"  multipage: {multipage}\n  z_slice: 5\n")
    run_preproc.main(["-c", str(cfg), "--device", "cpu"])
    jcfg = JaxPC()
    jcfg.preprocess.channels = CHANNELS
    jcfg.preprocess.multipage = multipage
    jcfg.preprocess.z_slice = 5
    jax_pre.run_preprocess(str(src), str(ref), jcfg)
    names = sorted(os.listdir(ref))
    assert sorted(os.listdir(ours)) == names == ["C5-Site_0.npy",
                                                 "C5-Site_1.npy"]
    for name in names:
        a, b = np.load(ours / name), np.load(ref / name)
        assert a.dtype == b.dtype == np.float64 and a.shape == b.shape == \
            (3, 3, 1, 40, 36)
        np.testing.assert_array_equal(a, b)
        site = src / name[:-4]
        phase = cv2.imread(str(site / "img_Phase2D.tif"
                               if multipage else
                               site / "img_Phase2D_t001_z005.tif"),
                           cv2.IMREAD_ANYDEPTH)
        np.testing.assert_array_equal(a[0 if multipage else 1, 0, 0], phase)


def test_run_preproc_raises_without_card(tmp_path):
    """Like every entry point, run_preproc runs only where its device is."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = tmp_path / "cfg.yml"
    cfg.write_text(f"preprocess:\n  image_dirs: ['{tmp_path}']\n"
                   f"  target_dirs: ['{tmp_path}']\n")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_preproc.main(["-c", str(cfg)])
