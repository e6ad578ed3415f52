"""The HDF5 files of the dataset path, read and written with `struct` and
`zlib` (the card's machine has no h5py): what h5py 3.14 writes for the JAX
package's ``save_to_hdf5`` (`facesr/data/prepare_data.py`), and nothing
else.

Such a file holds, in its root group:

- ``HR`` and ``LR``: uint8 ``(n, s, s, 3)``, chunked one image a chunk,
  each chunk deflated at level 4;
- ``filenames``: fixed-length ``S`` strings, contiguous;
- the scalar int64 attributes ``hr_size``, ``lr_size`` and ``num_images``.

`H5File` reads the structures h5py writes for it: superblock version 0,
version-1 object headers (with continuation blocks), the root group as a
symbol table (a version-1 group B-tree, SNOD nodes, a local heap), the
dataspace, datatype, fill-value, layout, filter-pipeline and attribute
messages, and the chunk index as a version-1 B-tree of any depth (FFHQ's
train split is ~60,000 chunks: three levels of at most 64 entries). A
chunk is read with ``os.pread`` and ``zlib.decompress``, which both release
the GIL and share one file descriptor, so loader threads read in parallel
with no handle of their own. Anything else raises `UnsupportedHDF5` naming
what it met: superblock 1-3 (h5py's ``libver="latest"`` writes 2 or 3),
version-2 object headers, new-style groups and dense attributes (fractal
heaps, version-2 B-trees), the shuffle, Fletcher-32, szip or any filter
but deflate, a chunk whose filter mask skips deflate, compact, virtual and
version-4 layouts, and any dtype but the three above. A truncated or
corrupt file raises `HDF5Error`.

`write_pairs` writes the same structures: h5py reads what it writes, and
each chunk is ``zlib.compress(image, 4)``, the payload h5py's deflate
filter writes.
"""

from __future__ import annotations

import os
import struct
import zlib
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple, Union

import numpy as np

from facesr_torch.data.image_errors import HDF5Error, UnsupportedHDF5

__all__ = ["HDF5Error", "UnsupportedHDF5", "H5File", "Dataset", "write_pairs", "SIGNATURE"]

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF
_GROUP_LEAF_K, _GROUP_INTERNAL_K, _CHUNK_K = 4, 16, 32  # HDF5's defaults, superblock 0
DEFLATE_LEVEL = 4  # h5py's compression="gzip" default

_MESSAGE_NAMES = {0x02: "link info (a new-style group)", 0x06: "link (a new-style group)",
                  0x0A: "group info (a new-style group)",
                  0x15: "attribute info (dense attributes in a fractal heap)",
                  0x07: "external data files", 0x0F: "shared message table",
                  0x18: "B-tree 'K' values", 0x19: "driver info"}
_FILTERS = {2: "shuffle", 3: "Fletcher-32", 4: "szip", 5: "N-bit", 6: "scale-offset",
            32000: "LZF", 32001: "Blosc", 32004: "LZ4", 32008: "bitshuffle",
            32015: "Zstandard"}
_LAYOUTS = {0: "compact", 3: "virtual"}
_CLASSES = {1: "floating-point", 2: "time", 4: "bit field", 5: "opaque", 6: "compound",
            7: "reference", 8: "enumerated", 9: "variable-length", 10: "array"}

PathLike = Union[str, Path]


class _Reader:
    """Positional reads of one file; ``os.pread`` is safe from any thread."""

    def __init__(self, path: PathLike):
        self.path = str(path)
        try:
            self.fd = os.open(self.path, os.O_RDONLY)
        except OSError as e:
            raise HDF5Error(f"cannot open {self.path}: {e}") from e
        self.size = os.fstat(self.fd).st_size

    def read(self, addr: int, n: int, what: str) -> bytes:
        if addr == UNDEF or addr < 0 or addr + n > self.size:
            raise HDF5Error(f"{self.path}: {what} at {addr:#x} (+{n}) lies past the end of "
                            f"the file ({self.size} bytes): truncated or corrupt")
        data = os.pread(self.fd, n, addr)
        if len(data) != n:
            raise HDF5Error(f"{self.path}: short read of {what} at {addr:#x}")
        return data

    def close(self) -> None:
        if self.fd >= 0:
            os.close(self.fd)
            self.fd = -1


class _Header:
    """The messages of a version-1 object header: [(type, flags, data)]."""

    def __init__(self, rd: _Reader, addr: int, name: str):
        head = rd.read(addr, 16, f"{name}'s object header")
        if head[:4] == b"OHDR":
            raise UnsupportedHDF5(f"{rd.path}: {name} has a version-2 object header (h5py's "
                                  "libver='latest'); not read by the port")
        version, _, nmsgs, _, size = struct.unpack("<BBHII", head[:12])
        if version != 1:
            raise HDF5Error(f"{rd.path}: {name}: object header version {version}")
        self.messages: List[Tuple[int, int, bytes]] = []
        blocks = [(addr + 16, size)]
        while blocks and len(self.messages) < nmsgs:
            at, length = blocks.pop(0)
            block = rd.read(at, length, f"{name}'s header messages")
            p = 0
            while p + 8 <= length and len(self.messages) < nmsgs:
                mtype, msize, flags = struct.unpack("<HHB", block[p:p + 5])
                data = block[p + 8:p + 8 + msize]
                if len(data) != msize:
                    raise HDF5Error(f"{rd.path}: {name}: a header message overruns its block")
                p += 8 + msize
                if mtype == 0x10:  # continuation
                    blocks.append(struct.unpack("<QQ", data[:16]))
                if flags & 0x02:
                    raise UnsupportedHDF5(f"{rd.path}: {name}: a shared header message "
                                          f"(type {mtype:#x}); not read by the port")
                self.messages.append((mtype, flags, data))
        if len(self.messages) != nmsgs:
            raise HDF5Error(f"{rd.path}: {name}: {len(self.messages)} of {nmsgs} header "
                            "messages found")

    def all(self, mtype: int) -> List[bytes]:
        return [d for t, _, d in self.messages if t == mtype]

    def one(self, mtype: int) -> Optional[bytes]:
        found = self.all(mtype)
        return found[0] if found else None


def _version(found: int, want: int, what: str, where: str) -> None:
    """Superblock 0 files carry the first version of each message."""
    if found != want:
        raise UnsupportedHDF5(f"{where}: a version-{found} {what}; not read by the port")


def _dataspace(data: bytes, where: str) -> Tuple[int, ...]:
    _version(data[0], 1, "dataspace", where)
    rank, flags = data[1], data[2]
    if flags & 0x02:
        raise UnsupportedHDF5(f"{where}: a dataspace with a permutation; not read by the port")
    return struct.unpack(f"<{rank}Q", data[8:8 + 8 * rank])


def _datatype(data: bytes, where: str) -> np.dtype:
    """A fixed-point or fixed-length string datatype -> its numpy dtype."""
    cls = data[0] & 0x0F
    bits = data[1]
    (size,) = struct.unpack("<I", data[4:8])
    if cls == 0:
        if bits & 0x01:
            raise UnsupportedHDF5(f"{where}: a big-endian integer type; not read by the port")
        offset, precision = struct.unpack("<HH", data[8:12])
        if size not in (1, 2, 4, 8) or offset != 0 or precision != 8 * size or bits & 0x06:
            raise UnsupportedHDF5(f"{where}: an integer type of {precision} bits in {size} "
                                  "bytes; not read by the port")
        return np.dtype(f"<{'i' if bits & 0x08 else 'u'}{size}")
    if cls == 3:
        if bits & 0x0F == 2:
            raise UnsupportedHDF5(f"{where}: a space-padded string type; not read by the port")
        return np.dtype(f"S{size}")
    what = _CLASSES.get(cls, f"class {cls}")
    raise UnsupportedHDF5(f"{where}: a {what} datatype of {size} bytes; not read by the port "
                          "(uint8 images, S strings and int64 attributes are)")


def _filters(data: bytes, where: str) -> List[Tuple[int, List[int]]]:
    """The filter pipeline -> [(id, client data)]."""
    _version(data[0], 1, "filter pipeline", where)
    p, out = 8, []
    for _ in range(data[1]):
        fid, nlen, _, nvals = struct.unpack("<HHHH", data[p:p + 8])
        p += 8 + ((nlen + 7) & ~7)
        out.append((fid, list(struct.unpack(f"<{nvals}I", data[p:p + 4 * nvals]))))
        p += 4 * (nvals + nvals % 2)
    for fid, _ in out:
        if fid != 1:
            raise UnsupportedHDF5(f"{where}: the {_FILTERS.get(fid, f'filter {fid}')} filter; "
                                  "not read by the port (deflate alone is)")
    return out


def _attribute(data: bytes, where: str) -> Tuple[str, int]:
    """A scalar integer attribute -> (name, value)."""
    _version(data[0], 1, "attribute message", where)
    nsize, tsize, ssize = struct.unpack("<HHH", data[2:8])
    p = 8

    def pad(n: int) -> int:
        return (n + 7) & ~7

    name = data[p:p + nsize].rstrip(b"\0").decode("utf-8", "replace")
    p += pad(nsize)
    dtype = _datatype(data[p:p + tsize], f"{where}: attribute {name!r}")
    p += pad(tsize)
    shape = _dataspace(data[p:p + ssize], f"{where}: attribute {name!r}")
    p += pad(ssize)
    if shape or dtype.kind not in "iu":
        raise UnsupportedHDF5(f"{where}: attribute {name!r} is not a scalar integer; not read "
                              "by the port")
    return name, int(np.frombuffer(data[p:p + dtype.itemsize], dtype)[0])


class Dataset:
    """One dataset of an `H5File`: ``HR``/``LR`` (chunked, one image a
    chunk, deflate) or ``filenames`` (contiguous strings)."""

    def __init__(self, f: "H5File", name: str, header: _Header):
        where = f"{f.path}: dataset {name!r}"
        self.file, self.name = f, name
        for mtype, _, _ in header.messages:
            if mtype in _MESSAGE_NAMES:
                raise UnsupportedHDF5(f"{where}: a {_MESSAGE_NAMES[mtype]} message; not read "
                                      "by the port")
        space, dtype, layout = header.one(0x01), header.one(0x03), header.one(0x08)
        if space is None or dtype is None or layout is None:
            raise HDF5Error(f"{where}: not a dataset (no dataspace, datatype or layout)")
        self.shape = tuple(int(x) for x in _dataspace(space, where))
        self.dtype = _datatype(dtype, where)
        version, cls = layout[0], layout[1]
        if version != 3:
            raise UnsupportedHDF5(f"{where}: a version-{version} data layout"
                                  f"{' (libver=latest)' if version == 4 else ''}; not read by "
                                  "the port")
        if cls in _LAYOUTS:
            raise UnsupportedHDF5(f"{where}: a {_LAYOUTS[cls]} layout; not read by the port "
                                  "(chunked images and contiguous strings are)")
        pipeline = header.one(0x0B)
        filters = _filters(pipeline, where) if pipeline is not None else []
        self.compression = "gzip" if filters else None
        self.compression_opts = filters[0][1][0] if filters and filters[0][1] else None
        self.chunks: Optional[Tuple[int, ...]] = None
        if cls == 1:  # contiguous
            if filters:
                raise HDF5Error(f"{where}: a filter on contiguous data")
            self._addr, self._size = struct.unpack("<QQ", layout[2:18])
            self._index = None
        elif cls == 2:  # chunked
            ndims = layout[2]
            (self._btree,) = struct.unpack("<Q", layout[3:11])
            dims = struct.unpack(f"<{ndims}I", layout[11:11 + 4 * ndims])
            self.chunks = tuple(int(x) for x in dims[:-1])
            if dims[-1] != self.dtype.itemsize or len(self.chunks) != len(self.shape) \
                    or self.dtype != np.uint8 or not self.shape \
                    or self.chunks != (1,) + self.shape[1:]:
                raise UnsupportedHDF5(f"{where}: {self.dtype} chunks of {self.chunks} in "
                                      f"{self.shape}; not read by the port (uint8, one image "
                                      "a chunk)")
            self._index = None
        else:
            raise HDF5Error(f"{where}: layout class {cls}")

    def __len__(self) -> int:
        return self.shape[0] if self.shape else 1

    def _chunk_index(self) -> np.ndarray:
        """[n, 2] (address, size) of each image's chunk, -1 where none was
        written, from the chunk B-tree (any depth)."""
        if self._index is not None:
            return self._index
        f, rank = self.file, len(self.shape) + 1
        ksize = 8 + 8 * rank
        nsize = 24 + (2 * _CHUNK_K + 1) * ksize + 2 * _CHUNK_K * 8
        index = np.full((self.shape[0], 2), -1, np.int64)
        key = np.dtype([("size", "<u4"), ("mask", "<u4"), ("off", "<u8", (rank,)),
                        ("child", "<u8")])
        todo = [] if self._btree == UNDEF else [self._btree]
        while todo:
            addr = todo.pop()
            node = f.rd.read(addr, nsize, f"dataset {self.name!r}'s chunk B-tree")
            if node[:4] != b"TREE" or node[4] != 1:
                raise HDF5Error(f"{f.path}: dataset {self.name!r}: bad chunk B-tree node at "
                                f"{addr:#x}")
            level = node[5]
            (used,) = struct.unpack("<H", node[6:8])
            if used > 2 * _CHUNK_K:
                raise HDF5Error(f"{f.path}: dataset {self.name!r}: {used} entries in a node")
            ent = np.frombuffer(node, key, used, 24)
            if level > 0:
                todo.extend(int(c) for c in ent["child"])
                continue
            if np.any(ent["mask"] != 0):
                i = int(ent["off"][np.flatnonzero(ent["mask"])[0], 0])
                raise UnsupportedHDF5(f"{f.path}: dataset {self.name!r}: chunk {i}'s filter "
                                      "mask skips deflate; not read by the port")
            off = ent["off"]
            if np.any(off[:, 1:] != 0) or np.any(off[:, 0] >= self.shape[0]):
                raise HDF5Error(f"{f.path}: dataset {self.name!r}: a chunk key outside the "
                                "dataset")
            index[off[:, 0].astype(np.int64), 0] = ent["child"].astype(np.int64)
            index[off[:, 0].astype(np.int64), 1] = ent["size"]
        self._index = index
        return index

    def image(self, i: int) -> np.ndarray:
        """Image ``i`` of a chunked dataset, (s, s, 3) uint8 (a new array,
        as h5py's ``ds[i]``)."""
        if self.chunks is None:
            raise TypeError(f"dataset {self.name!r} is not chunked")
        n = self.shape[0]
        if not -n <= i < n:
            raise IndexError(f"index {i} out of range for dataset {self.name!r} of {n}")
        i %= n
        addr, size = self._chunk_index()[i]
        want = int(np.prod(self.shape[1:]))
        if addr < 0:  # never written: the fill value, 0
            return np.zeros(self.shape[1:], np.uint8)
        raw = self.file.rd.read(int(addr), int(size), f"chunk {i} of {self.name!r}")
        if self.compression:
            try:
                raw = zlib.decompress(raw)
            except zlib.error as e:
                raise HDF5Error(f"{self.file.path}: dataset {self.name!r}: chunk {i}: {e}") \
                    from None
        if len(raw) != want:
            raise HDF5Error(f"{self.file.path}: dataset {self.name!r}: chunk {i} holds "
                            f"{len(raw)} bytes, want {want}")
        return np.frombuffer(raw, np.uint8).reshape(self.shape[1:]).copy()

    def read(self) -> np.ndarray:
        """The whole dataset (a chunked one image by image)."""
        if self.chunks is not None:
            out = np.empty(self.shape, self.dtype)
            for i in range(self.shape[0]):
                out[i] = self.image(i)
            return out
        n = int(np.prod(self.shape)) * self.dtype.itemsize
        if self._addr == UNDEF or n == 0:
            return np.zeros(self.shape, self.dtype)
        raw = self.file.rd.read(self._addr, n, f"dataset {self.name!r}")
        return np.frombuffer(raw, self.dtype).reshape(self.shape).copy()

    def __getitem__(self, key) -> np.ndarray:
        if isinstance(key, (int, np.integer)) and self.chunks is not None:
            return self.image(int(key))
        return self.read()[key]


class H5File:
    """An ``.h5`` file as ``save_to_hdf5`` writes it: ``f["HR"]``,
    ``"filenames" in f``, ``f.attrs["hr_size"]``. Safe to share between
    threads; `close` (or ``with``) releases the file."""

    def __init__(self, path: PathLike):
        self.path = str(path)
        self.rd = _Reader(path)
        try:
            self._open()
        except BaseException:
            self.rd.close()
            raise

    def _open(self) -> None:
        rd = self.rd
        head = os.pread(rd.fd, 96, 0)
        if head[:8] != SIGNATURE:
            if self._signature_elsewhere():
                raise UnsupportedHDF5(f"{self.path}: an HDF5 file with a user block; not "
                                      "read by the port")
            raise HDF5Error(f"{self.path}: not an HDF5 file")
        version = head[8]
        if version != 0:
            hint = " (h5py's libver='latest')" if version in (2, 3) else ""
            raise UnsupportedHDF5(f"{self.path}: superblock version {version}{hint}; not read "
                                  "by the port (version 0, h5py's default, is)")
        if len(head) < 96:
            raise HDF5Error(f"{self.path}: truncated superblock")
        soff, slen = head[13], head[14]
        leaf_k, internal_k = struct.unpack("<HH", head[16:20])
        if (soff, slen) != (8, 8) or (leaf_k, internal_k) != (_GROUP_LEAF_K, _GROUP_INTERNAL_K):
            raise UnsupportedHDF5(f"{self.path}: {soff}-byte offsets, {slen}-byte lengths, "
                                  f"group K {leaf_k}/{internal_k}; not read by the port")
        base, _, eof, _ = struct.unpack("<QQQQ", head[24:56])
        if base != 0:
            raise UnsupportedHDF5(f"{self.path}: base address {base:#x}; not read by the port")
        if eof > rd.size:
            raise HDF5Error(f"{self.path}: truncated ({rd.size} of {eof} bytes)")
        (root,) = struct.unpack("<Q", head[64:72])
        header = _Header(rd, root, "the root group")
        for mtype, _, _ in header.messages:
            if mtype in _MESSAGE_NAMES:
                raise UnsupportedHDF5(f"{self.path}: the root group has a "
                                      f"{_MESSAGE_NAMES[mtype]} message; not read by the port")
        table = header.one(0x11)
        if table is None:
            raise HDF5Error(f"{self.path}: the root group has no symbol table")
        btree, heap = struct.unpack("<QQ", table[:16])
        self.attrs: Dict[str, int] = dict(_attribute(a, f"{self.path}: the root group")
                                          for a in header.all(0x0C))
        self._members = self._group(btree, heap)
        self._datasets: Dict[str, Dataset] = {}

    def _signature_elsewhere(self) -> bool:
        at = 512
        while at + 8 <= self.rd.size:
            if os.pread(self.rd.fd, 8, at) == SIGNATURE:
                return True
            at *= 2
        return False

    def _group(self, btree: int, heap: int) -> Dict[str, int]:
        """name -> object header address of every member of a symbol-table
        group (its B-tree of any depth, its SNOD nodes, its local heap)."""
        rd = self.rd
        h = rd.read(heap, 32, "the root group's local heap")
        if h[:4] != b"HEAP" or h[4] != 0:
            raise HDF5Error(f"{self.path}: bad local heap at {heap:#x}")
        size, _, data_addr = struct.unpack("<QQQ", h[8:32])
        names = rd.read(data_addr, size, "the local heap's data")
        nsize = 24 + (2 * _GROUP_INTERNAL_K + 1) * 8 + 2 * _GROUP_INTERNAL_K * 8
        snod_size = 8 + 2 * _GROUP_LEAF_K * 40
        members: Dict[str, int] = {}
        todo = [btree]
        while todo:
            node = rd.read(todo.pop(), nsize, "the root group's B-tree")
            if node[:4] != b"TREE" or node[4] != 0:
                raise HDF5Error(f"{self.path}: bad group B-tree node")
            level = node[5]
            (used,) = struct.unpack("<H", node[6:8])
            children = [struct.unpack("<Q", node[32 + 16 * i:40 + 16 * i])[0]
                        for i in range(used)]
            if level > 0:
                todo.extend(children)
                continue
            for child in children:
                snod = rd.read(child, snod_size, "a symbol table node")
                if snod[:4] != b"SNOD":
                    raise HDF5Error(f"{self.path}: bad symbol table node at {child:#x}")
                (count,) = struct.unpack("<H", snod[6:8])
                for i in range(count):
                    off, addr = struct.unpack("<QQ", snod[8 + 40 * i:24 + 40 * i])
                    end = names.find(b"\0", off)
                    members[names[off:end].decode("utf-8", "replace")] = addr
        return members

    def __contains__(self, name: str) -> bool:
        return name in self._members

    def keys(self) -> List[str]:
        return sorted(self._members)

    def __getitem__(self, name: str) -> Dataset:
        if name not in self._datasets:
            if name not in self._members:
                raise KeyError(f"{self.path}: no object {name!r}")
            header = _Header(self.rd, self._members[name], f"dataset {name!r}")
            self._datasets[name] = Dataset(self, name, header)
        return self._datasets[name]

    def close(self) -> None:
        self.rd.close()

    def __enter__(self) -> "H5File":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        rd = getattr(self, "rd", None)
        if rd is not None:
            rd.close()


# ---------------------------------------------------------------------------
# the writer


def _message(mtype: int, data: bytes, flags: int = 0) -> bytes:
    data += b"\0" * (-len(data) % 8)
    return struct.pack("<HHB3x", mtype, len(data), flags) + data


def _object_header(messages: List[bytes]) -> bytes:
    body = b"".join(messages)
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body


def _space(shape: Tuple[int, ...]) -> bytes:
    flags = 1 if shape else 0
    dims = struct.pack(f"<{len(shape)}Q", *shape)
    return struct.pack("<BBB5x", 1, len(shape), flags) + dims + (dims if shape else b"")


_UINT8 = struct.pack("<BBBBIHH", 0x10, 0, 0, 0, 1, 0, 8)
_INT64 = struct.pack("<BBBBIHH", 0x10, 0x08, 0, 0, 8, 0, 64)


def _string(size: int) -> bytes:
    return struct.pack("<BBBBI", 0x13, 0x01, 0, 0, size)  # null-padded ASCII


def _attribute_message(name: str, value: int) -> bytes:
    raw = name.encode() + b"\0"
    pad = lambda b: b + b"\0" * (-len(b) % 8)  # noqa: E731
    space = _space(())
    data = struct.pack("<BBHHH", 1, 0, len(raw), len(_INT64), len(space)) + pad(raw) + \
        pad(_INT64) + pad(space) + struct.pack("<q", value)
    return _message(0x0C, data)


def _btree_nodes(keys: List[bytes], children: List[int], right_key: bytes, node_type: int,
                 k: int, at: int) -> Tuple[bytes, int, int]:
    """A version-1 B-tree over sorted (key, child) entries, built bottom
    up with full nodes of ``2 k`` entries, laid out from offset ``at``:
    (the bytes, the root's address, the root's level)."""
    ksize = len(right_key)
    nsize = 24 + (2 * k + 1) * ksize + 2 * k * 8
    out = bytearray()
    level = 0
    while True:
        groups = [list(range(s, min(s + 2 * k, len(children))))
                  for s in range(0, len(children), 2 * k)] or [[]]
        addrs = [at + len(out) + j * nsize for j in range(len(groups))]
        for j, grp in enumerate(groups):
            left = addrs[j - 1] if j > 0 else UNDEF
            right = addrs[j + 1] if j + 1 < len(groups) else UNDEF
            node = bytearray(struct.pack("<4sBBHQQ", b"TREE", node_type, level, len(grp), left,
                                         right))
            for i in grp:
                node += keys[i] + struct.pack("<Q", children[i])
            node += keys[groups[j + 1][0]] if j + 1 < len(groups) else right_key
            out += node + b"\0" * (nsize - len(node))
        if len(groups) == 1:
            return bytes(out), addrs[0], level
        keys = [keys[g[0]] for g in groups]
        children = addrs
        level += 1


def write_pairs(path: PathLike, pairs: Iterable[Tuple[np.ndarray, np.ndarray, str]],
                hr_size: int, lr_size: int) -> int:
    """Write ``(hr, lr, filename)`` triples (uint8 ``(hr_size, hr_size, 3)``
    and ``(lr_size, lr_size, 3)`` RGB) as ``save_to_hdf5`` does: ``HR``,
    ``LR`` and ``filenames``, the attributes ``hr_size``, ``lr_size`` and
    ``num_images``. The pairs are streamed to the file one chunk at a time;
    returns their count. Raises ValueError on a wrong shape or an empty
    list (h5py refuses a chunk larger than the dataset)."""
    shapes = {"HR": (hr_size, hr_size, 3), "LR": (lr_size, lr_size, 3)}
    chunks: Dict[str, List[Tuple[int, int]]] = {"HR": [], "LR": []}
    names: List[bytes] = []
    with open(path, "wb") as fh:
        fh.write(b"\0" * 96)  # the superblock, written last
        at = 96
        for hr, lr, name in pairs:
            for key, img in (("HR", hr), ("LR", lr)):
                img = np.asarray(img)
                if img.dtype != np.uint8 or img.shape != shapes[key]:
                    raise ValueError(f"{name}: {key} is {img.dtype} {img.shape}, want uint8 "
                                     f"{shapes[key]}")
                payload = zlib.compress(np.ascontiguousarray(img).tobytes(), DEFLATE_LEVEL)
                fh.write(payload)
                chunks[key].append((at, len(payload)))
                at += len(payload)
            names.append(name.encode("ascii"))
        n = len(names)
        if n == 0:
            raise ValueError("Chunk shape must not be greater than data shape in any "
                             f"dimension. (1, {hr_size}, {hr_size}, 3) is not compatible "
                             f"with (0, {hr_size}, {hr_size}, 3)")
        width = max(len(s) for s in names) or 1
        strings = b"".join(s.ljust(width, b"\0") for s in names)
        tail = bytearray()

        def put(data: bytes) -> int:
            addr = at + len(tail)
            tail.extend(data)
            return addr

        headers = {}
        names_addr = put(strings)
        fill_late = _message(0x05, bytes([2, 2, 2, 1]) + bytes(4), flags=1)
        headers["filenames"] = [
            _message(0x01, _space((n,))), _message(0x03, _string(width), flags=1), fill_late,
            _message(0x08, struct.pack("<BBQQ", 3, 1, names_addr, len(strings)))]
        for key, shape in shapes.items():
            rank = len(shape) + 2  # the chunk key's offsets: n, the image's axes, the element
            keys = [struct.pack(f"<II{rank}Q", size, 0, i, *(0,) * (rank - 1))
                    for i, (_, size) in enumerate(chunks[key])]
            right = struct.pack(f"<II{rank}Q", 0, 0, n, *shape, 1)
            tree, root, _ = _btree_nodes(keys, [a for a, _ in chunks[key]], right, 1,
                                         _CHUNK_K, at + len(tail))
            tail.extend(tree)
            pipeline = struct.pack("<BB6xHHHH8sI4x", 1, 1, 1, 8, 1, 1, b"deflate\0",
                                   DEFLATE_LEVEL)
            layout = struct.pack(f"<BBBQ{rank}I", 3, 2, rank, root, 1, *shape, 1)
            headers[key] = [
                _message(0x01, _space((n,) + shape)), _message(0x03, _UINT8, flags=1),
                _message(0x05, bytes([2, 3, 2, 1]) + bytes(4), flags=1),
                _message(0x0B, pipeline, flags=1), _message(0x08, layout)]
        addrs = {key: put(_object_header(msgs)) for key, msgs in headers.items()}
        # the root group: local heap of names, one SNOD, a one-leaf B-tree
        order = sorted(addrs, key=lambda s: s.encode())
        heap_data, offsets = bytearray(b"\0" * 8), {}
        for s in order:
            offsets[s] = len(heap_data)
            raw = s.encode() + b"\0"
            heap_data += raw + b"\0" * (-len(raw) % 8)
        heap_addr = put(struct.pack("<4sB3xQQQ", b"HEAP", 0, len(heap_data), 1,
                                    at + len(tail) + 32))
        put(bytes(heap_data))
        snod = bytearray(struct.pack("<4sBBH", b"SNOD", 1, 0, len(order)))
        for s in order:
            snod += struct.pack("<QQII16x", offsets[s], addrs[s], 0, 0)
        snod_addr = put(bytes(snod) + b"\0" * (8 + 2 * _GROUP_LEAF_K * 40 - len(snod)))
        gtree, groot, _ = _btree_nodes([struct.pack("<Q", 0)], [snod_addr],
                                       struct.pack("<Q", offsets[order[-1]]), 0,
                                       _GROUP_INTERNAL_K, at + len(tail))
        tail.extend(gtree)
        root_addr = put(_object_header(
            [_message(0x11, struct.pack("<QQ", groot, heap_addr)),
             _attribute_message("hr_size", hr_size), _attribute_message("lr_size", lr_size),
             _attribute_message("num_images", n)]))
        fh.write(tail)
        eof = at + len(tail)
        fh.seek(0)
        fh.write(SIGNATURE + struct.pack("<BBBBBBBBHHI", 0, 0, 0, 0, 0, 8, 8, 0,
                                         _GROUP_LEAF_K, _GROUP_INTERNAL_K, 0)
                 + struct.pack("<QQQQ", 0, UNDEF, eof, UNDEF)
                 + struct.pack("<QQII", 0, root_addr, 1, 0) + struct.pack("<QQ", groot, heap_addr))
    return n
