"""A read-only HDF5 reader, in numpy, for the files that Keras 2 and h5py's
default file settings write.

Keras saves weights with ``model.save_weights(path)`` (and whole models with
``model.save``) as HDF5, and the reference's segmentation inputs and patch
files are HDF5 from h5py; the port reads them without h5py. The subset:

- superblock versions 0 and 1 (h5py's default ``libver="earliest"``),
  after a user block or not;
- version-1 object headers, their continuation blocks included (the
  ``layer_names`` and ``weight_names`` attributes of a Keras file fill a
  group's first header block, so its other messages move on);
- old-style groups: the symbol-table message, the version-1 B-tree of
  symbol nodes (``TREE``/``SNOD``) and the local heap (``HEAP``) of the
  link names. Members come back in the B-tree's order, which is sorted by
  name, as h5py lists them;
- datasets: the dataspace (version 1), little-endian IEEE floats
  of 2, 4 and 8 bytes and fixed-point integers of 1, 2, 4 and 8 bytes,
  signed and unsigned; layout message version 3 with compact, contiguous
  and chunked storage (the version-1 B-tree of chunks); the filter
  pipeline (version 1) with deflate (``zlib``) and shuffle; the fill value
  where storage was never written.

Anything outside it raises ``NotImplementedError`` naming the feature:
superblocks 2 and 3 (``libver="latest"``), version-2 object headers, new-
style groups (link messages, dense link storage), shared messages, other
filters, big-endian or other datatypes, external storage, soft links.
Attributes are skipped: nothing the port reads needs them.

``walk(path)`` yields ``(name, array)`` for every dataset, ``keys(path)``
lists the root's members and ``read(path, name)`` reads one dataset;
``File`` holds one open file for several reads (and walks or lists a
group).
"""
from __future__ import annotations

import mmap
import struct
import zlib
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

_SIGNATURE = b"\x89HDF\r\n\x1a\n"

# object header message types
_NIL, _DATASPACE, _LINK_INFO, _DATATYPE, _FILL_OLD, _FILL = 0, 1, 2, 3, 4, 5
_LINK, _EXTERNAL, _LAYOUT, _FILTERS, _CONTINUATION, _SYMBOL_TABLE = \
    6, 7, 8, 11, 16, 17

_DEFLATE, _SHUFFLE = 1, 2
_FILTER_NAMES = {3: "fletcher32", 4: "szip", 5: "nbit", 6: "scaleoffset",
                 32000: "lzf", 32001: "blosc", 32004: "lz4",
                 32008: "bitshuffle", 32015: "zstd"}
_TYPE_CLASSES = ("fixed-point", "floating-point", "time", "string",
                 "bitfield", "opaque", "compound", "reference", "enum",
                 "variable-length", "array")


class File:
    """One HDF5 file, mapped read-only. Use as a context manager, or call
    ``close``."""

    def __init__(self, path: str):
        self.path = path
        self._fh = open(path, "rb")
        try:
            self._mm = mmap.mmap(self._fh.fileno(), 0,
                                 access=mmap.ACCESS_READ)
            self._superblock()
        except BaseException:
            self.close()
            raise

    def close(self) -> None:
        mm = getattr(self, "_mm", None)
        if mm is not None:
            mm.close()
            self._mm = None
        self._fh.close()

    def __enter__(self) -> "File":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- raw fields ----------------------------------------------------
    def _uint(self, off: int, n: int) -> int:
        return int.from_bytes(self._mm[off: off + n], "little")

    def _addr(self, off: int) -> Optional[int]:
        """A file address relative to the base, or None where undefined
        (all bits set)."""
        v = self._uint(off, self._so)
        if v == (1 << (8 * self._so)) - 1:
            return None
        return v + self._base

    def _superblock(self) -> None:
        mm = self._mm
        start = 0
        while mm[start: start + 8] != _SIGNATURE:
            start = 512 if start == 0 else start * 2
            if start + 8 > len(mm):
                raise ValueError(f"{self.path} is not an HDF5 file")
        version = mm[start + 8]
        if version not in (0, 1):
            raise NotImplementedError(
                f"{self.path}: HDF5 superblock version {version} (written "
                "with libver='latest' or another newer format); this reader "
                "takes superblock versions 0 and 1 only")
        self._so, self._sl = mm[start + 13], mm[start + 14]
        p = start + 24 + (4 if version == 1 else 0)
        self._base = 0
        self._base = self._addr(p)
        p += 4 * self._so        # base, free-space, end-of-file, file-info
        self._root = self._addr(p + self._so)     # the root's symbol entry

    # -- object headers ------------------------------------------------
    def _header(self, addr: int) -> Dict[int, int]:
        """{message type: body offset} of the version-1 object header at
        ``addr`` (the first message of each type), continuation blocks
        followed."""
        mm = self._mm
        if mm[addr: addr + 4] == b"OHDR":
            raise NotImplementedError(
                f"{self.path}: version-2 object headers (libver='latest' "
                "or track_order)")
        if mm[addr] != 1:
            raise ValueError(f"{self.path}: no object header at {addr}")
        blocks = [(addr + 16, self._uint(addr + 8, 4))]
        out: Dict[int, int] = {}
        while blocks:
            start, size = blocks.pop(0)
            p, end = start, start + size
            while p + 8 <= end:
                mtype, msize = self._uint(p, 2), self._uint(p + 2, 2)
                body = p + 8
                if mm[p + 4] & 2:
                    raise NotImplementedError(
                        f"{self.path}: shared object header message (type "
                        f"{mtype})")
                if mtype == _CONTINUATION:
                    blocks.append((self._addr(body),
                                   self._uint(body + self._so, self._sl)))
                elif mtype != _NIL:
                    out.setdefault(mtype, body)
                p = body + msize
        if _LINK_INFO in out or _LINK in out:
            raise NotImplementedError(
                f"{self.path}: new-style groups (link messages or dense link "
                "storage, libver='latest' or track_order)")
        return out

    # -- groups --------------------------------------------------------
    def _members(self, msgs: Dict[int, int]) -> List[Tuple[str, int]]:
        """(name, object header address) of the members of the group whose
        header is ``msgs``, sorted by name."""
        if _SYMBOL_TABLE not in msgs:
            raise ValueError(f"{self.path}: not a group")
        body = msgs[_SYMBOL_TABLE]
        btree, heap = self._addr(body), self._addr(body + self._so)
        mm = self._mm
        if mm[heap: heap + 4] != b"HEAP":
            raise ValueError(f"{self.path}: bad local heap at {heap}")
        heap_data = self._addr(heap + 8 + 2 * self._sl)
        out = []
        for snod in self._btree(btree, 0):
            if mm[snod: snod + 4] != b"SNOD":
                raise ValueError(f"{self.path}: bad symbol node at {snod}")
            entry = snod + 8
            for _ in range(self._uint(snod + 6, 2)):
                name_off = self._uint(entry, self._so)
                obj = self._addr(entry + self._so)
                cache = self._uint(entry + 2 * self._so, 4)
                if cache == 2:
                    raise NotImplementedError(f"{self.path}: soft links")
                p = heap_data + name_off
                name = mm[p: mm.find(b"\0", p)].decode("utf-8")
                out.append((name, obj))
                entry += 2 * self._so + 24
        return out

    def _btree(self, addr: Optional[int], node_type: int,
               rank: int = 0) -> Iterator:
        """The leaves of a version-1 B-tree in key order: symbol-node
        addresses (``node_type`` 0), or (chunk size, filter mask, chunk
        offsets, address) of raw-data chunks (1, of a ``rank``-dimensional
        dataset)."""
        if addr is None:
            return
        mm = self._mm
        if mm[addr: addr + 4] != b"TREE" or mm[addr + 4] != node_type:
            raise ValueError(f"{self.path}: bad B-tree node at {addr}")
        level, used = mm[addr + 5], self._uint(addr + 6, 2)
        key_size = self._sl if node_type == 0 else 8 + 8 * (rank + 1)
        p = addr + 8 + 2 * self._so
        for _ in range(used):
            key, child = p, self._addr(p + key_size)
            p += key_size + self._so
            if level > 0:
                yield from self._btree(child, node_type, rank)
            elif node_type == 0:
                yield child
            else:
                offsets = struct.unpack_from(f"<{rank}Q", mm, key + 8)
                yield (self._uint(key, 4), self._uint(key + 4, 4), offsets,
                       child)

    def _lookup(self, name: str) -> Dict[int, int]:
        """The object header of the object at path ``name``."""
        msgs = self._header(self._root)
        for part in (p for p in name.split("/") if p):
            members = dict(self._members(msgs))
            if part not in members:
                raise KeyError(f"{name!r} is not in {self.path}")
            msgs = self._header(members[part])
        return msgs

    def keys(self, group: str = "") -> List[str]:
        """The names of the members of ``group`` (the root by default), in
        h5py's order."""
        return [n for n, _ in self._members(self._lookup(group))]

    def walk(self, group: str = "") -> Iterator[Tuple[str, np.ndarray]]:
        """``(path, array)`` of every dataset under ``group`` (the root by
        default; paths relative to it), depth first in name order; an
        object linked twice is read once."""
        seen = set()

        def visit(prefix: str, header: Dict[int, int]):
            for name, obj in self._members(header):
                if obj in seen:
                    continue
                seen.add(obj)
                msgs = self._header(obj)
                if _SYMBOL_TABLE in msgs:
                    yield from visit(prefix + name + "/", msgs)
                else:
                    yield prefix + name, self._dataset(msgs)

        yield from visit("", self._lookup(group))

    def read(self, name: str) -> np.ndarray:
        """The dataset at path ``name``."""
        return self._dataset(self._lookup(name))

    # -- datasets ------------------------------------------------------
    def _dataset(self, msgs: Dict[int, int]) -> np.ndarray:
        """The dataset whose object header is ``msgs``."""
        if _EXTERNAL in msgs:
            raise NotImplementedError(f"{self.path}: external storage")
        if not {_DATASPACE, _DATATYPE, _LAYOUT} <= set(msgs):
            raise ValueError(f"{self.path}: not a dataset")
        shape = self._dataspace(msgs[_DATASPACE])
        dtype = self._datatype(msgs[_DATATYPE])
        filters = self._filters(msgs[_FILTERS]) if _FILTERS in msgs else []
        fill = self._fill(msgs, dtype)
        mm = self._mm
        p = msgs[_LAYOUT]
        if mm[p] != 3:
            raise NotImplementedError(
                f"{self.path}: data layout message version {mm[p]}")
        layout = mm[p + 1]
        n = int(np.prod(shape, dtype=np.int64))
        if layout == 0:                                  # compact
            if self._uint(p + 2, 2) != n * dtype.itemsize:
                raise ValueError(f"{self.path}: compact data of the wrong "
                                 "size")
            return self._array(p + 4, n, dtype, shape)
        if layout == 1:                                  # contiguous
            data = self._addr(p + 2)
            if data is None:                             # never written
                return np.full(shape, fill, dtype)
            return self._array(data, n, dtype, shape)
        if layout != 2:
            raise NotImplementedError(
                f"{self.path}: data layout class {layout}")
        rank = mm[p + 2] - 1
        btree = self._addr(p + 3)
        chunk = struct.unpack_from(f"<{rank}I", mm, p + 3 + self._so)
        out = np.full(shape, fill, dtype)
        for size, mask, offsets, caddr in self._btree(btree, 1, rank):
            raw = self._mm[caddr: caddr + size]
            for i in reversed(range(len(filters))):
                if not mask >> i & 1:
                    raw = self._unfilter(filters[i], raw)
            block = np.frombuffer(raw, dtype,
                                  int(np.prod(chunk))).reshape(chunk)
            dst = tuple(slice(o, min(o + c, s))
                        for o, c, s in zip(offsets, chunk, shape))
            out[dst] = block[tuple(slice(0, d.stop - d.start) for d in dst)]
        return out

    def _array(self, off: int, n: int, dtype: np.dtype, shape) -> np.ndarray:
        """A writable copy of ``n`` elements at ``off``."""
        return np.frombuffer(self._mm, dtype, n, off).reshape(shape).copy()

    def _dataspace(self, p: int) -> Tuple[int, ...]:
        version, rank = self._mm[p], self._mm[p + 1]
        if version != 1:
            raise NotImplementedError(
                f"{self.path}: dataspace message version {version}")
        return tuple(self._uint(p + 8 + i * self._sl, self._sl)
                     for i in range(rank))

    def _datatype(self, p: int) -> np.dtype:
        mm = self._mm
        cls, bits, size = mm[p] & 0x0F, mm[p + 1], self._uint(p + 4, 4)
        if cls not in (0, 1):
            name = _TYPE_CLASSES[cls] if cls < len(_TYPE_CLASSES) else cls
            raise NotImplementedError(f"{self.path}: {name} datatype")
        if bits & 1 or (cls == 1 and bits & 0x40):
            raise NotImplementedError(f"{self.path}: big-endian datatype")
        offset, precision = self._uint(p + 8, 2), self._uint(p + 10, 2)
        if offset or precision != 8 * size:
            raise NotImplementedError(
                f"{self.path}: a {precision}-bit field at bit {offset} of "
                f"a {size}-byte datatype")
        if cls == 0 and size in (1, 2, 4, 8):
            return np.dtype(f"<{'i' if bits & 8 else 'u'}{size}")
        if cls == 1 and size in (2, 4, 8):
            return np.dtype(f"<f{size}")
        raise NotImplementedError(
            f"{self.path}: {_TYPE_CLASSES[cls]} datatype of {size} bytes")

    def _fill(self, msgs: Dict[int, int], dtype: np.dtype):
        """The fill value of storage never written (0 unless the file
        defines one)."""
        mm = self._mm
        val = None
        if _FILL in msgs:
            p = msgs[_FILL]
            version = mm[p]
            if version in (1, 2):
                if version == 1 or mm[p + 3]:
                    val = p + 4
            elif version == 3:
                if mm[p + 1] & 0x20:
                    val = p + 2
            else:
                raise NotImplementedError(
                    f"{self.path}: fill value message version {version}")
        elif _FILL_OLD in msgs:
            val = msgs[_FILL_OLD]
        if val is None or self._uint(val, 4) != dtype.itemsize:
            return 0
        return np.frombuffer(self._mm, dtype, 1, val + 4)[0]

    def _filters(self, p: int) -> List[Tuple[int, Tuple[int, ...]]]:
        """(filter id, client data) of each filter of the pipeline, in the
        order they were applied when writing."""
        mm = self._mm
        version, n = mm[p], mm[p + 1]
        if version != 1:
            raise NotImplementedError(
                f"{self.path}: filter pipeline message version {version}")
        p += 8
        out = []
        for _ in range(n):
            fid, name_len = self._uint(p, 2), self._uint(p + 2, 2)
            n_cd = self._uint(p + 6, 2)
            p += 8 + name_len
            cd = struct.unpack_from(f"<{n_cd}I", mm, p)
            p += 4 * (n_cd + n_cd % 2)
            if fid not in (_DEFLATE, _SHUFFLE):
                raise NotImplementedError(
                    f"{self.path}: HDF5 filter {fid} "
                    f"({_FILTER_NAMES.get(fid, 'unknown')}); this reader "
                    "takes deflate and shuffle only")
            out.append((fid, cd))
        return out

    @staticmethod
    def _unfilter(flt, raw: bytes) -> bytes:
        fid, cd = flt
        if fid == _DEFLATE:
            return zlib.decompress(raw)
        size = cd[0] if cd else 1                       # shuffle
        n = len(raw) // size
        planes = np.frombuffer(raw, np.uint8, n * size).reshape(size, n)
        return planes.T.tobytes() + raw[n * size:]


def walk(path: str) -> Iterator[Tuple[str, np.ndarray]]:
    """``(path, array)`` of every dataset of the file, depth first in name
    order."""
    with File(path) as f:
        yield from f.walk()


def keys(path: str) -> List[str]:
    """The member names of the root group, sorted by name as h5py lists an
    old-style group."""
    with File(path) as f:
        return f.keys()


def read(path: str, name: str) -> np.ndarray:
    """The dataset ``name`` (a path within the file)."""
    with File(path) as f:
        return f.read(name)
