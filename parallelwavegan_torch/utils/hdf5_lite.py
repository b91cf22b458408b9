"""A reader and a writer for the HDF5 files of feature dumps, without h5py.

The dumps that ``bin/preprocess``, ``bin/compute_statistics`` and
``bin/normalize`` write (and the reference toolkit's, through h5py with its
defaults) are HDF5 files of superblock version 0 whose root group holds a
few numeric datasets ("wave", "feats", "f0", "excitation", "local",
"global", "mean", "scale"). The reader walks the chain such a file is
made of:

    superblock v0/v1 -> the root group's symbol-table entry
    -> its object header (version 1, continuation messages followed)
    -> the symbol-table message -> the group's v1 B-tree ("TREE")
    -> symbol nodes ("SNOD") -> names in the local heap ("HEAP")
    -> each dataset's object header: dataspace, datatype, fill value and
       layout messages (contiguous or compact; an undefined address is a
       dataset never written, read as its fill value)

and reads little-endian IEEE floats (16, 32, 64 bits) and integers (8 to
64 bits, signed or not) of any shape, scalars included, in nested groups
too. Attributes and modification times are skipped. Everything else
raises a ``ValueError`` that names what it found: other superblock or
object-header versions, new-style (link-message) groups, chunked or
virtual layouts, filters, external files, other datatype classes,
big-endian data.

The writer writes the same structure as h5py does by default (superblock
0, one v1 B-tree node over symbol nodes of eight entries, contiguous data),
so h5py and the reader read it back; a file holds at most 256 datasets
(one B-tree node) in its root group. ``io.write_hdf5`` keeps the JAX
package's key-by-key append by reading a file's datasets and writing the
file anew.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Tuple

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEFINED = 0xFFFFFFFFFFFFFFFF
LEAF_K = 4        # symbol-node entries: 2 * LEAF_K
INTERNAL_K = 16   # B-tree children: 2 * INTERNAL_K
ENTRY_SIZE = 40   # a symbol-table entry with 8-byte offsets
MAX_DATASETS = 2 * LEAF_K * 2 * INTERNAL_K

# object header message types
NIL, DATASPACE, LINK_INFO, DATATYPE, FILL_OLD, FILL = 0x0, 0x1, 0x2, 0x3, \
    0x4, 0x5
LINK, EXTERNAL, LAYOUT, BOGUS, GROUP_INFO, FILTERS = 0x6, 0x7, 0x8, 0x9, \
    0xA, 0xB
ATTRIBUTE, COMMENT, MTIME_OLD, SHARED_TABLE, CONTINUATION = 0xC, 0xD, 0xE, \
    0xF, 0x10
SYMBOL_TABLE, MTIME, BTREE_K, DRIVER_INFO, ATTR_INFO, REFCOUNT = 0x11, \
    0x12, 0x13, 0x14, 0x15, 0x16
_SKIPPED = {NIL, FILL_OLD, FILL, ATTRIBUTE, COMMENT, MTIME_OLD, MTIME,
            BTREE_K, ATTR_INFO, REFCOUNT, BOGUS}
_MESSAGE_NAMES = {LINK_INFO: "link info (a new-style group)",
                  LINK: "link (a new-style group)", EXTERNAL: "external files",
                  FILTERS: "a filter pipeline", GROUP_INFO: "group info",
                  SHARED_TABLE: "shared messages", DRIVER_INFO: "driver info"}

# IEEE layouts: size -> (sign bit, exponent location and size, mantissa
# location and size, exponent bias)
_IEEE = {2: (15, 10, 5, 0, 10, 15), 4: (31, 23, 8, 0, 23, 127),
         8: (63, 52, 11, 0, 52, 1023)}


class _File:
    """A file's bytes and the walk from the root group."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            self.buf = f.read()
        if self.buf[:8] != SIGNATURE:
            raise ValueError(f"{path}: not an HDF5 file (no signature at "
                             "offset 0)")
        version = self.buf[8]
        if version not in (0, 1):
            raise ValueError(f"{path}: superblock version {version}; only "
                             "versions 0 and 1 are read")
        offsets, lengths = self.buf[13], self.buf[14]
        if offsets != 8 or lengths != 8:
            raise ValueError(f"{path}: {offsets}-byte offsets and "
                             f"{lengths}-byte lengths; only 8 are read")
        # v1 adds the indexed-storage K and two reserved bytes
        entry = 24 + (4 if version == 1 else 0) + 32
        self.base = self._u64(24 + (4 if version == 1 else 0))
        self.root = self._u64(entry + 8)

    def _u64(self, at: int) -> int:
        return struct.unpack_from("<Q", self.buf, at)[0]

    def _addr(self, addr: int) -> int:
        return self.base + addr

    def messages(self, addr: int) -> List[Tuple[int, bytes]]:
        """(type, data) of every message of the v1 object header at
        ``addr``, continuation blocks followed."""
        at = self._addr(addr)
        if self.buf[at:at + 4] == b"OHDR":
            raise ValueError(f"{self.path}: a version 2 object header; "
                             "only version 1 is read")
        version, _, count, _, size = struct.unpack_from("<BBHII", self.buf,
                                                        at)
        if version != 1:
            raise ValueError(f"{self.path}: object header version {version} "
                             f"at {addr}; only version 1 is read")
        blocks = [(at + 16, size)]
        out: List[Tuple[int, bytes]] = []
        while blocks and len(out) < count:
            start, size = blocks.pop(0)
            p, end = start, start + size
            while p + 8 <= end and len(out) < count:
                kind, length, flags = struct.unpack_from("<HHB", self.buf, p)
                data = self.buf[p + 8:p + 8 + length]
                if flags & 0x2:
                    raise ValueError(f"{self.path}: a shared message of "
                                     f"type {kind:#x}")
                out.append((kind, data))
                if kind == CONTINUATION:
                    cont, clen = struct.unpack_from("<QQ", data)
                    blocks.append((self._addr(cont), clen))
                p += 8 + length
        return out

    def heap_name(self, segment: int, offset: int) -> str:
        at = segment + offset
        end = self.buf.index(b"\0", at)
        return self.buf[at:end].decode("utf-8")

    def group(self, addr: int) -> Dict[str, int]:
        """name -> object header address of the group whose object header
        is at ``addr``."""
        table = None
        for kind, data in self.messages(addr):
            if kind == SYMBOL_TABLE:
                table = struct.unpack_from("<QQ", data)
            elif kind in (LINK_INFO, LINK):
                raise ValueError(f"{self.path}: a new-style group (link "
                                 "messages); only symbol-table groups are "
                                 "read")
        if table is None:
            raise ValueError(f"{self.path}: the object at {addr} is not a "
                             "group")
        btree, heap = table
        h = self._addr(heap)
        if self.buf[h:h + 4] != b"HEAP":
            raise ValueError(f"{self.path}: no local heap at {heap}")
        segment = self._addr(self._u64(h + 24))
        out: Dict[str, int] = {}
        self._walk(btree, segment, out)
        return out

    def _walk(self, addr: int, segment: int, out: Dict[str, int]) -> None:
        at = self._addr(addr)
        if self.buf[at:at + 4] != b"TREE":
            raise ValueError(f"{self.path}: no B-tree node at {addr}")
        kind, level, used = struct.unpack_from("<BBH", self.buf, at + 4)
        if kind != 0:
            raise ValueError(f"{self.path}: a B-tree of type {kind} where a "
                             "group's is expected")
        for i in range(used):
            child = self._u64(at + 24 + 8 + 16 * i)
            if level > 0:
                self._walk(child, segment, out)
                continue
            node = self._addr(child)
            if self.buf[node:node + 4] != b"SNOD":
                raise ValueError(f"{self.path}: no symbol node at {child}")
            (n,) = struct.unpack_from("<H", self.buf, node + 6)
            for j in range(n):
                name_off, header = struct.unpack_from(
                    "<QQ", self.buf, node + 8 + ENTRY_SIZE * j)
                out[self.heap_name(segment, name_off)] = header

    def lookup(self, name: str):
        """The object header address of ``name`` ("a" or "grp/a"), or
        None."""
        addr = self.root
        for part in [p for p in name.split("/") if p]:
            members = self.group(addr)
            if part not in members:
                return None
            addr = members[part]
        return addr

    def is_group(self, addr: int) -> bool:
        return any(kind == SYMBOL_TABLE for kind, _ in self.messages(addr))

    def dataset(self, addr: int, name: str) -> np.ndarray:
        shape = dtype = layout = None
        fill = b""
        for kind, data in self.messages(addr):
            if kind == DATASPACE:
                shape = _dataspace(data, self.path, name)
            elif kind == DATATYPE:
                dtype = _datatype(data, self.path, name)
            elif kind == LAYOUT:
                layout = data
            elif kind == FILL:
                fill = _fill_value(data)
            elif kind not in _SKIPPED and kind != CONTINUATION:
                what = _MESSAGE_NAMES.get(kind, f"message type {kind:#x}")
                raise ValueError(f"{self.path}: dataset {name!r} has {what}; "
                                 "it is outside the subset read")
        if shape is None or dtype is None or layout is None:
            raise ValueError(f"{self.path}: {name!r} is not a dataset")
        count = int(np.prod(shape, dtype=np.int64))
        nbytes = count * dtype.itemsize
        version, cls = layout[0], layout[1]
        if version != 3:
            raise ValueError(f"{self.path}: dataset {name!r} has a layout "
                             f"message of version {version}; only 3 is read")
        if cls == 0:  # compact: the data in the message
            (size,) = struct.unpack_from("<H", layout, 2)
            raw = layout[4:4 + size]
        elif cls == 1:  # contiguous
            where, size = struct.unpack_from("<QQ", layout, 2)
            if where == UNDEFINED:
                value = (np.frombuffer(fill, dtype)[0] if len(fill) ==
                         dtype.itemsize else 0)
                return np.full(shape, value, dtype.newbyteorder("="))
            start = self._addr(where)
            raw = self.buf[start:start + size]
        else:
            kind = {2: "chunked", 3: "virtual"}.get(cls, f"class {cls}")
            raise ValueError(f"{self.path}: dataset {name!r} has a {kind} "
                             "layout; only contiguous and compact are read")
        if len(raw) < nbytes:
            raise ValueError(f"{self.path}: dataset {name!r} holds "
                             f"{len(raw)} bytes, its shape {shape} needs "
                             f"{nbytes}")
        return np.frombuffer(raw[:nbytes], dtype).reshape(shape).astype(
            dtype.newbyteorder("="))


def _dataspace(data: bytes, path: str, name: str) -> Tuple[int, ...]:
    version, ndims, flags = data[0], data[1], data[2]
    if version == 1:
        at = 8
    elif version == 2:
        if data[3] == 2:
            raise ValueError(f"{path}: dataset {name!r} has a null "
                             "dataspace")
        at = 4
    else:
        raise ValueError(f"{path}: dataset {name!r} has a dataspace of "
                         f"version {version}")
    return tuple(struct.unpack_from(f"<{ndims}Q", data, at))


def _datatype(data: bytes, path: str, name: str) -> np.dtype:
    cls, bits0, bits1 = data[0] & 0x0F, data[1], data[2]
    (size,) = struct.unpack_from("<I", data, 4)
    if cls not in (0, 1):
        kind = {2: "time", 3: "string", 4: "bitfield", 5: "opaque",
                6: "compound", 7: "reference", 8: "enum",
                9: "variable-length", 10: "array"}.get(cls, f"class {cls}")
        raise ValueError(f"{path}: dataset {name!r} has a {kind} datatype; "
                         "only integers and floats are read")
    if bits0 & 0x1:
        raise ValueError(f"{path}: dataset {name!r} is big-endian; only "
                         "little-endian data is read")
    offset, precision = struct.unpack_from("<HH", data, 8)
    if offset != 0 or precision != 8 * size:
        raise ValueError(f"{path}: dataset {name!r} has {precision} bits at "
                         f"offset {offset} in {size} bytes")
    if cls == 0:
        if size not in (1, 2, 4, 8):
            raise ValueError(f"{path}: dataset {name!r} has {size}-byte "
                             "integers")
        return np.dtype(f"<{'i' if bits0 & 0x8 else 'u'}{size}")
    layout = (bits1,) + struct.unpack_from("<BBBBI", data, 12)
    if _IEEE.get(size) != layout or (bits0 & 0x30) != 0x20:
        raise ValueError(f"{path}: dataset {name!r} has a {size}-byte float "
                         f"that is not IEEE ({layout})")
    return np.dtype(f"<f{size}")


def _fill_value(data: bytes) -> bytes:
    version = data[0]
    if version in (1, 2):
        if data[3] and len(data) >= 8:
            (size,) = struct.unpack_from("<I", data, 4)
            return data[8:8 + size]
        return b""
    if version == 3:
        flags = data[1]
        if flags & 0x20:
            (size,) = struct.unpack_from("<I", data, 2)
            return data[6:6 + size]
    return b""


def read(path: str, name: str) -> np.ndarray:
    """The dataset ``name`` ("feats", or "grp/feats") of the file; a
    ``KeyError`` if it has none."""
    f = _File(path)
    addr = f.lookup(name)
    if addr is None or f.is_group(addr):
        raise KeyError(name)
    return f.dataset(addr, name)


def keys(path: str) -> List[str]:
    """The names of the root group's members, sorted."""
    f = _File(path)
    return sorted(f.group(f.root))


def read_all(path: str) -> Dict[str, np.ndarray]:
    """Every dataset of a flat file (a root group of datasets), by name.
    A nested group raises: the writer writes none."""
    f = _File(path)
    out = {}
    for name, addr in sorted(f.group(f.root).items()):
        if f.is_group(addr):
            raise ValueError(f"{path}: {name!r} is a group; only files of "
                             "datasets in the root group are rewritten")
        out[name] = f.dataset(addr, name)
    return out


# -- the writer ----------------------------------------------------------

def _message(kind: int, data: bytes, flags: int = 0) -> bytes:
    data = data + b"\0" * (-len(data) % 8)
    return struct.pack("<HHB3x", kind, len(data), flags) + data


def _object_header(messages: List[bytes]) -> bytes:
    body = b"".join(messages)
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body


def _datatype_message(dtype: np.dtype) -> bytes:
    size = dtype.itemsize
    if dtype.kind == "f":
        if size not in _IEEE:
            raise TypeError(f"cannot write {dtype} to HDF5")
        sign, exp_loc, exp_size, man_loc, man_size, bias = _IEEE[size]
        return struct.pack("<BBBBIHHBBBBI", 0x11, 0x20, sign, 0, size, 0,
                           8 * size, exp_loc, exp_size, man_loc, man_size,
                           bias)
    if dtype.kind in "iu":
        return struct.pack("<BBBBIHH", 0x10, 0x08 if dtype.kind == "i" else 0,
                           0, 0, size, 0, 8 * size)
    raise TypeError(f"cannot write {dtype} to HDF5: only integers and "
                    "floats")


def _dataset_header(array: np.ndarray, where: int) -> bytes:
    shape = array.shape
    space = struct.pack("<BBBB4x", 1, len(shape), 1 if shape else 0, 0)
    space += struct.pack(f"<{2 * len(shape)}Q", *shape, *shape)
    # fill value: version 2, late allocation, written if set, default (0)
    fill = struct.pack("<BBBBI", 2, 2, 2, 1, 0)
    layout = struct.pack("<BBQQ", 3, 1, where if array.nbytes else UNDEFINED,
                         array.nbytes)
    return _object_header([
        _message(DATASPACE, space), _message(DATATYPE, _datatype_message(
            array.dtype), flags=1),
        _message(FILL, fill, flags=1), _message(LAYOUT, layout)])


def encode(datasets: Dict[str, np.ndarray]) -> bytes:
    """The bytes of an HDF5 file whose root group holds ``datasets``."""
    names = sorted(datasets)
    for name in names:
        if not name or "/" in name or "\0" in name or name == ".":
            raise ValueError(f"cannot write a dataset named {name!r}: a "
                             "name in the root group is written")
    if len(names) > MAX_DATASETS:
        raise ValueError(f"{len(names)} datasets: at most {MAX_DATASETS} "
                         "are written to one file")
    arrays = {}
    for name in names:
        array = np.asarray(datasets[name])
        array = array.astype(array.dtype.newbyteorder("<"), order="C",
                             copy=False)
        _datatype_message(array.dtype)  # refuse what cannot be written
        arrays[name] = array

    # the local heap's data: "" at 0, then each name, 8-byte aligned
    heap_data = bytearray(8)
    offsets = {}
    for name in names:
        offsets[name] = len(heap_data)
        raw = name.encode("utf-8") + b"\0"
        heap_data += raw + b"\0" * (-len(raw) % 8)
    nodes = [names[i:i + 2 * LEAF_K] for i in range(0, len(names),
                                                     2 * LEAF_K)] or [[]]

    superblock_size = 96
    root_at = superblock_size
    btree_at = root_at + 16 + 8 + 16  # a header of one symbol-table message
    btree_size = 24 + 2 * INTERNAL_K * 8 + (2 * INTERNAL_K + 1) * 8
    heap_at = btree_at + btree_size
    heap_data_at = heap_at + 32
    snod_size = 8 + 2 * LEAF_K * ENTRY_SIZE
    snod_at = heap_data_at + len(heap_data)
    header_at = snod_at + snod_size * len(nodes)
    headers = {}
    at = header_at
    for name in names:
        headers[name] = at
        at += len(_dataset_header(arrays[name], 0))
    data_at = {}
    for name in names:
        at += -at % 8
        data_at[name] = at
        at += arrays[name].nbytes
    eof = at

    out = bytearray(eof)
    struct.pack_into("<8sBBBBBBBBHHI", out, 0, SIGNATURE, 0, 0, 0, 0, 0, 8,
                     8, 0, LEAF_K, INTERNAL_K, 0)
    struct.pack_into("<QQQQ", out, 24, 0, UNDEFINED, eof, UNDEFINED)
    # the root group's symbol-table entry, with the cached B-tree and heap
    struct.pack_into("<QQII QQ", out, 56, 0, root_at, 1, 0, btree_at,
                     heap_at)
    root_header = _object_header([_message(
        SYMBOL_TABLE, struct.pack("<QQ", btree_at, heap_at))])
    out[root_at:root_at + len(root_header)] = root_header
    # the B-tree: one leaf node, a child per symbol node, keyed by the
    # heap offset of each node's last name
    struct.pack_into("<4sBBHQQ", out, btree_at, b"TREE", 0, 0, len(nodes),
                     UNDEFINED, UNDEFINED)
    p = btree_at + 24
    struct.pack_into("<Q", out, p, 0)
    for i, node in enumerate(nodes):
        last = offsets[node[-1]] if node else 0
        struct.pack_into("<QQ", out, p + 8 + 16 * i, snod_at + snod_size * i,
                         last)
    # the local heap: no free block (offset 1 ends the free list)
    struct.pack_into("<4sB3xQQQ", out, heap_at, b"HEAP", 0, len(heap_data),
                     1, heap_data_at)
    out[heap_data_at:heap_data_at + len(heap_data)] = heap_data
    for i, node in enumerate(nodes):
        s = snod_at + snod_size * i
        struct.pack_into("<4sBBH", out, s, b"SNOD", 1, 0, len(node))
        for j, name in enumerate(node):
            struct.pack_into("<QQII", out, s + 8 + ENTRY_SIZE * j,
                             offsets[name], headers[name], 0, 0)
    for name in names:
        header = _dataset_header(arrays[name], data_at[name])
        out[headers[name]:headers[name] + len(header)] = header
        raw = arrays[name].tobytes()
        out[data_at[name]:data_at[name] + len(raw)] = raw
    return bytes(out)


def write(path: str, datasets: Dict[str, np.ndarray]) -> None:
    """Write ``datasets`` as the whole file at ``path``."""
    data = encode(datasets)
    with open(path, "wb") as f:
        f.write(data)
