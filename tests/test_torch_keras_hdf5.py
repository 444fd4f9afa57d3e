"""The port's read-only HDF5 reader (``io/hdf5.py``) against h5py, the
HDF5 writer of ``chip_smoke.py`` read back by h5py and by the JAX
package's Keras importer, and ``seg/data.py``'s ``.h5`` inputs and labels
against the JAX package's.

Each layout is written with h5py at its default (earliest) file format:
Keras's ``save_weights`` layout (``tests/test_keras_import.py``) both ways,
a ``model.save``-style file whose attributes push group messages into
continuation blocks, chunked storage with deflate and shuffle, compact
storage, every integer and float type, fill values, a user block and a
group whose B-tree has two levels. Every dataset must come back equal,
with its dtype and shape, in h5py's order. Files outside the subset must
raise ``NotImplementedError`` naming the feature.
"""
import json
import re

import h5py
import numpy as np
import pytest

from dynamorph_tpu.seg import data as jax_data
from dynamorph_tpu.seg import keras_import as jax_ki
from dynamorph_tpu_torch.io import hdf5
from dynamorph_tpu_torch.seg import data as port_data
from test_keras_import import write_keras_h5

KERAS_LAYERS = {
    "pre_conv": {"kernel:0": (1, 1, 2, 3), "bias:0": (3,)},
    "conv0": {"kernel:0": (7, 7, 3, 64)},
    "bn_data": {"beta:0": (3,), "moving_mean:0": (3,),
                "moving_variance:0": (3,)},
    "stage1_unit1_bn1": {"gamma:0": (64,), "beta:0": (64,),
                         "moving_mean:0": (64,), "moving_variance:0": (64,)},
    "final_conv": {"kernel:0": (3, 3, 16, 3), "bias:0": (3,)},
}


def _keras_weights(seed=0):
    r = np.random.RandomState(seed)
    return {layer: {k: r.randn(*shape).astype(np.float32)
                    for k, shape in lw.items()}
            for layer, lw in KERAS_LAYERS.items()}


def _model_save(path):
    """A ``model.save``-style file: root attributes with the model's JSON
    config, layer groups under ``model_weights`` whose ``layer_names`` /
    ``weight_names`` attributes are added after their members (so their
    object headers continue in further blocks), and ``optimizer_weights``
    beside them."""
    W = _keras_weights(1)
    with h5py.File(path, "w") as f:
        mw = f.create_group("model_weights")
        for layer, lw in W.items():
            g = mw.create_group(layer)
            for k, v in lw.items():
                g.create_dataset(f"{layer}/{k}", data=v)
            g.attrs["weight_names"] = np.array(
                [f"{layer}/{k}".encode() for k in lw] * 40)
        mw.attrs["layer_names"] = np.array(
            [n.encode() for n in W] + [f"pad_{i:04d}".encode()
                                       for i in range(2000)])
        mw.attrs["backend"] = b"tensorflow"
        f.attrs["model_config"] = json.dumps(
            {"layers": [{"name": f"layer_{i}", "config": {"units": i}}
                        for i in range(600)]}).encode()
        f.attrs["keras_version"] = b"2.3.1"
        opt = f.create_group("optimizer_weights/Adam")
        opt.create_dataset("iterations:0", data=np.int64(7))
        opt.create_dataset("conv0/kernel/m:0", data=np.ones((2, 2)))


def _write(layout, path):
    r = np.random.RandomState(2)
    if layout == "save_weights":
        write_keras_h5(path, _keras_weights(), nested_name="model_1")
        return
    if layout == "model_weights":
        write_keras_h5(path, _keras_weights(), nested_name="model_5",
                       wrap_model_weights=True)
        return
    if layout == "model_save":
        _model_save(path)
        return
    with h5py.File(path, "w", userblock_size=512 if layout == "userblock"
                   else 0) as f:
        if layout == "chunked_deflate_shuffle":
            f.create_dataset("a", data=r.rand(37, 41).astype(np.float32),
                             chunks=(8, 16), compression="gzip",
                             shuffle=True)
            f.create_dataset("g/b", data=r.randint(0, 60000, (3, 37, 41))
                             .astype(np.uint16), chunks=(1, 10, 16),
                             compression="gzip", compression_opts=9)
            f.create_dataset("g/c", data=r.rand(100), chunks=(30,),
                             shuffle=True)
        elif layout == "compact":
            space = h5py.h5s.create_simple((6, 5))
            dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
            dcpl.set_layout(h5py.h5d.COMPACT)
            ds = h5py.h5d.create(f.id, b"compact", h5py.h5t.NATIVE_FLOAT,
                                 space, dcpl=dcpl)
            ds.write(h5py.h5s.ALL, h5py.h5s.ALL,
                     r.rand(6, 5).astype(np.float32))
        elif layout == "float64_uint16":
            f.create_dataset("t0", data=r.rand(2, 3, 1, 16, 16))
            f.create_dataset("t1", data=r.randint(0, 65535, (2, 3, 1, 16, 16))
                             .astype(np.uint16))
        elif layout == "all_types":
            for dt in ("<i1", "<u1", "<i2", "<u2", "<i4", "<u4", "<i8",
                       "<u8", "<f2", "<f4", "<f8"):
                info = np.iinfo(dt) if dt[1] in "iu" else None
                v = r.randint(info.min, info.max, (4, 6), dtype=dt) \
                    if info else (r.randn(4, 6) * 100).astype(dt)
                f.create_dataset(f"d_{dt[1:]}", data=v)
            f.create_dataset("scalar", data=np.float32(2.5))
            f.create_dataset("empty", data=np.zeros((0, 3), np.float32))
        elif layout == "fill_values":
            f.create_dataset("unwritten", shape=(4, 3), dtype="f4")
            f.create_dataset("filled", shape=(4, 3), dtype="f8",
                             fillvalue=7.5)
            f.create_dataset("partial", shape=(40,), dtype="i4",
                             chunks=(10,), fillvalue=-3)
            f["partial"][5:12] = 9
        elif layout == "userblock":
            f.create_dataset("x", data=np.arange(10.0))
            f.create_dataset("g/y", data=np.arange(4))
        else:
            assert layout == "two_level_btree"
            g = f.create_group("many")
            for i in range(300):
                g.create_dataset(f"n{i}", data=np.full(i % 7 + 1, i))


LAYOUTS = ["save_weights", "model_weights", "model_save",
           "chunked_deflate_shuffle", "compact", "float64_uint16",
           "all_types", "fill_values", "userblock", "two_level_btree"]


def _h5py_tree(path):
    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda n, o: out.__setitem__(n, o[()])
                     if isinstance(o, h5py.Dataset) else None)
        groups = {"": list(f.keys())}
        f.visititems(lambda n, o: groups.__setitem__(n, list(o.keys()))
                     if isinstance(o, h5py.Group) else None)
    return out, groups


def _continuations(path):
    """Object headers of the file whose messages continue in another
    block (a continuation message, type 16)."""
    n = 0
    with hdf5.File(path) as f:
        todo = [f._root]
        while todo:
            addr = todo.pop()
            p, end = addr + 16, addr + 16 + f._uint(addr + 8, 4)
            while p + 8 <= end:
                n += f._uint(p, 2) == 16
                p += 8 + f._uint(p + 2, 2)
            header = f._header(addr)
            if 17 in header:                    # a symbol-table group
                todo += [a for _, a in f._members(header)]
    return n


@pytest.mark.parametrize("layout", LAYOUTS)
def test_reader_matches_h5py(layout, tmp_path):
    path = str(tmp_path / f"{layout}.h5")
    _write(layout, path)
    want, groups = _h5py_tree(path)
    got = list(hdf5.walk(path))
    assert sorted(n for n, _ in got) == sorted(want)
    for name, arr in got:
        assert arr.dtype == want[name].dtype, name
        assert arr.shape == np.shape(want[name]), name
        np.testing.assert_array_equal(arr, want[name], err_msg=name)
        assert arr.flags.writeable
    with hdf5.File(path) as f:
        for group, members in groups.items():
            assert f.keys(group) == members, group
        name = next(iter(want))
        np.testing.assert_array_equal(f.read(name), want[name])
    assert hdf5.keys(path) == groups[""]
    if layout == "model_save":
        assert _continuations(path) > 0


def _refused(feature, path):
    r = np.random.RandomState(3)
    kw = {"libver": "latest"} if feature == "superblock version 3" else {}
    with h5py.File(path, "w", track_order=feature == "version-2 object",
                   **kw) as f:
        if feature == "big-endian":
            f.create_dataset("x", data=np.arange(6.0).astype(">f4"))
        elif feature == "filter 32000 (lzf)":
            f.create_dataset("x", data=r.rand(50), chunks=(10,),
                             compression="lzf")
        elif feature == "filter 3 (fletcher32)":
            f.create_dataset("x", data=r.rand(50), chunks=(10,),
                             fletcher32=True)
        elif feature == "string datatype":
            f.create_dataset("x", data=np.array([b"ab", b"cd"]))
        elif feature == "soft links":
            f.create_dataset("x", data=np.arange(3))
            f["y"] = h5py.SoftLink("/x")
        else:
            f.create_dataset("x", data=np.arange(3))


@pytest.mark.parametrize("feature", [
    "superblock version 3", "version-2 object", "big-endian",
    "filter 32000 (lzf)", "filter 3 (fletcher32)", "string datatype",
    "soft links"])
def test_reader_refuses_what_it_does_not_read(feature, tmp_path):
    """Outside the subset the reader raises NotImplementedError naming the
    feature, never a wrong array."""
    path = str(tmp_path / "x.h5")
    _refused(feature, path)
    with pytest.raises(NotImplementedError, match=re.escape(feature)):
        dict(hdf5.walk(path))


@pytest.mark.parametrize("nested", [None, "model_1"])
def test_chip_smoke_writer_reads_back(nested, tmp_path):
    """chip_smoke.py's own HDF5 writer (the card's machine has no h5py):
    h5py reads its datasets and the Keras ``layer_names`` /
    ``weight_names`` attributes, the JAX package's importer reads the
    layers equal, and so does the port's reader."""
    import chip_smoke

    W = _keras_weights(4)
    W["extra"] = {"x:0": np.arange(12, dtype=np.float64).reshape(3, 4),
                  "n:0": np.arange(5, dtype=np.uint16)}
    path = str(tmp_path / "w.h5")
    tree, attrs = chip_smoke.keras_h5_layout(W, nested=nested)
    chip_smoke.write_h5(path, tree, attrs)
    want, _ = _h5py_tree(path)
    got = dict(hdf5.walk(path))
    assert sorted(got) == sorted(want)
    for name, arr in got.items():
        assert arr.dtype == want[name].dtype
        np.testing.assert_array_equal(arr, want[name])
    layers = jax_ki.read_keras_layer_weights(path)
    assert sorted(layers) == sorted(W)
    for layer, lw in W.items():
        for k, v in lw.items():
            got_v = layers[layer][k.split(":")[0]]
            assert got_v.dtype == v.dtype
            np.testing.assert_array_equal(got_v, v)
    with h5py.File(path, "r") as f:
        outer = list(f.attrs["layer_names"])
        assert outer == [n.encode() for n in tree]
        group = f[nested] if nested else f["conv0"]
        names = [n.decode() for n in group.attrs["weight_names"]]
        expect = [f"{layer}/{k}" for layer, lw in W.items()
                  if nested is None and layer == "conv0"
                  or nested is not None and layer != "pre_conv"
                  for k in lw]
        assert names == expect
        for n in names:
            np.testing.assert_array_equal(group[n][()], W[n.split("/")[0]][
                n.split("/")[1]])


@pytest.mark.parametrize("what", ["input_keys_sorted", "input_one_key",
                                  "label_first_key", "label_uint8"])
def test_seg_data_h5_matches_jax(what, tmp_path):
    """``load_input`` (every dataset, stacked in sorted-key order) and
    ``load_label`` (the first dataset in h5py's order) read an ``.h5`` as
    the JAX package does with h5py."""
    r = np.random.RandomState(5)
    path = str(tmp_path / "x.h5")
    with h5py.File(path, "w") as f:
        if what == "input_keys_sorted":
            for key in ("t10", "t2", "t1"):
                f.create_dataset(key, data=r.rand(2, 1, 8, 8))
        elif what == "input_one_key":
            f.create_dataset("stack", data=r.randint(
                0, 65535, (2, 1, 8, 8)).astype(np.uint16))
        elif what == "label_first_key":
            f.create_dataset("b", data=r.randint(0, 3, (2, 1, 8, 8)))
            f.create_dataset("a", data=r.rand(2, 1, 8, 8),
                             chunks=(1, 1, 8, 8), compression="gzip")
        else:
            f.create_dataset("label", data=r.randint(0, 4, (1, 8, 8))
                             .astype(np.uint8))
    fn = "load_label" if what.startswith("label") else "load_input"
    got, want = getattr(port_data, fn)(path), getattr(jax_data, fn)(path)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
