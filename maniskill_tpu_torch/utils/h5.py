"""A reader and writer for the HDF5 files RecordEpisode writes, without h5py.

The port's stand-in for ``h5py`` (as ``gym_utils`` stands in for
gymnasium): the card's machine has no h5py, and the demo files
(``demos/*/mp_*.h5``) and every trajectory file of both packages are HDF5.
It covers the subset that h5py writes with its default ``libver="earliest"``:

- superblock version 0 (or 1) with 8-byte offsets and lengths;
- version-1 object headers, with continuation messages;
- symbol-table groups: a version-1 B-tree of type 0 over symbol-table nodes
  (SNOD), the names in a local heap;
- scalar or simple dataspaces;
- IEEE float32/float64, fixed-point int8-64 and uint8-64 in either byte
  order, and the 1-byte enum ``{FALSE: 0, TRUE: 1}`` that h5py writes for
  numpy ``bool``;
- contiguous, unfiltered storage (layout message version 3).

The reader refuses every other feature with ``UnsupportedHDF5``: chunked,
compact or filtered storage, external files, superblocks of version 2 or 3,
groups with compact or dense link storage, soft links, committed datatypes,
or a datatype outside the list. It reads each dataset's contiguous block
with one seek and one read.

The writer lays a file out as h5py's defaults would (group leaf K 4,
internal K 16): raw data is appended as datasets are created, and the
metadata (object headers, heaps, B-trees) is written by ``flush`` and
``close``. A group of any size gets a B-tree of as many levels as it needs
(``traj_0`` .. ``traj_4095`` of a RecordEpisode file at 4096 envs).

    with File("out.h5", "w") as f:
        g = f.create_group("traj_0")
        g.create_dataset("actions", data=np.zeros((4, 8), np.float32))
    with File("out.h5", "r") as f:
        f["traj_0/actions"][()]  # (4, 8) float32
"""
from __future__ import annotations

import os
import struct
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF
LEAF_K, INTERNAL_K = 4, 16  # h5py's defaults: 8 symbols per SNOD, 32 children per B-tree node
SNOD_SIZE = 8 + 2 * LEAF_K * 40
BTREE_SIZE = 24 + 2 * INTERNAL_K * 8 + (2 * INTERNAL_K + 1) * 8

# object header message types
MSG_NIL, MSG_DATASPACE, MSG_LINK_INFO, MSG_DATATYPE = 0x0, 0x1, 0x2, 0x3
MSG_FILL, MSG_LINK, MSG_EXTERNAL, MSG_LAYOUT = 0x5, 0x6, 0x7, 0x8
MSG_FILTERS, MSG_CONTINUATION, MSG_SYMBOL_TABLE = 0xB, 0x10, 0x11
# messages that change what a dataset's bytes mean or where they are
_REFUSED = {
    MSG_LINK_INFO: "a group with compact or dense link storage (new-style group)",
    MSG_LINK: "a link message (new-style group)",
    MSG_EXTERNAL: "external data files",
    MSG_FILTERS: "a filter pipeline (compression or shuffle)",
}

_INT_TYPES = [np.dtype(f"{k}{n}") for k in "iu" for n in (1, 2, 4, 8)]


class UnsupportedHDF5(ValueError):
    """The file uses a feature outside the subset this module reads."""


def _pad8(n: int) -> int:
    return (n + 7) & ~7


# ============================================================================
# reader
# ============================================================================
class _Reader:
    def __init__(self, path):
        self.f = open(path, "rb")
        try:
            self._superblock(path)
        except Exception:
            self.f.close()
            raise

    def _superblock(self, path):
        head = self.read(0, 96)
        if head[:8] != SIGNATURE:
            raise UnsupportedHDF5(f"{path}: not an HDF5 file (no signature at offset 0)")
        version = head[8]
        if version not in (0, 1):
            raise UnsupportedHDF5(f"{path}: superblock version {version} (only 0 and 1 are read)")
        if head[13] != 8 or head[14] != 8:
            raise UnsupportedHDF5(f"{path}: {head[13]}-byte offsets, {head[14]}-byte lengths (only 8 are read)")
        pos = 24 + (4 if version == 1 else 0)
        base, _, _, _ = struct.unpack_from("<4Q", self.read(pos, 32))
        if base != 0:
            raise UnsupportedHDF5(f"{path}: base address {base} (only 0 is read)")
        self.root_addr = self._entry(self.read(pos + 32, 40))[1]

    def read(self, addr: int, n: int) -> bytes:
        self.f.seek(addr)
        b = self.f.read(n)
        if len(b) != n:
            raise UnsupportedHDF5(f"truncated file: {n} bytes wanted at {addr}, {len(b)} there")
        return b

    @staticmethod
    def _entry(b: bytes) -> Tuple[int, int, int]:
        """A symbol table entry: (name offset, object header address, cache type)."""
        name_off, header, cache = struct.unpack_from("<QQI", b)
        if cache == 2:
            raise UnsupportedHDF5("a soft link")
        return name_off, header, cache

    def messages(self, addr: int) -> List[Tuple[int, bytes]]:
        """The (type, data) of every message of the version-1 object header at
        ``addr``, continuation blocks followed."""
        head = self.read(addr, 16)
        if head[:4] == b"OHDR":
            raise UnsupportedHDF5("a version-2 object header")
        version, _, _, _, size = struct.unpack_from("<BBHII", head)
        if version != 1:
            raise UnsupportedHDF5(f"object header version {version}")
        out, blocks = [], [(addr + 16, size)]
        while blocks:
            start, size = blocks.pop(0)
            block, p = self.read(start, size), 0
            while p + 8 <= size:
                mtype, msize, flags = struct.unpack_from("<HHB", block, p)
                data = block[p + 8:p + 8 + msize]
                p += 8 + msize
                if mtype == MSG_CONTINUATION:
                    blocks.append(struct.unpack_from("<QQ", data))
                elif mtype != MSG_NIL:
                    if flags & 0x2:
                        raise UnsupportedHDF5(f"a shared message (type {mtype:#x}; committed datatype)")
                    out.append((mtype, data))
        return out

    def heap(self, addr: int):
        head = self.read(addr, 32)
        if head[:4] != b"HEAP":
            raise UnsupportedHDF5(f"no local heap at {addr}")
        size, _, data_addr = struct.unpack_from("<QQQ", head, 8)
        return self.read(data_addr, size)

    def group_entries(self, btree_addr: int, heap_addr: int) -> List[Tuple[str, int]]:
        """(name, object header address) of a symbol-table group's members,
        in the B-tree's (name) order."""
        heap = self.heap(heap_addr)
        out = []

        def name(off):
            return heap[off:heap.index(b"\0", off)].decode()

        def visit(addr):
            head = self.read(addr, 24)
            if head[:4] != b"TREE":
                raise UnsupportedHDF5(f"no v1 B-tree node at {addr}")
            node_type, level, used = struct.unpack_from("<BBH", head, 4)
            if node_type != 0:
                raise UnsupportedHDF5(f"B-tree node type {node_type} in a group")
            body = self.read(addr + 24, used * 16 + 8)
            children = [struct.unpack_from("<Q", body, 8 + 16 * i)[0] for i in range(used)]
            for child in children:
                if level > 0:
                    visit(child)
                    continue
                snod = self.read(child, 8)
                if snod[:4] != b"SNOD":
                    raise UnsupportedHDF5(f"no symbol table node at {child}")
                n = struct.unpack_from("<H", snod, 6)[0]
                entries = self.read(child + 8, 40 * n)
                for i in range(n):
                    off, header, _ = self._entry(entries[40 * i:40 * i + 40])
                    out.append((name(off), header))

        visit(btree_addr)
        return out


def _parse_datatype(b: bytes) -> np.dtype:
    cls, version = b[0] & 0x0F, b[0] >> 4
    bits = b[1] | (b[2] << 8) | (b[3] << 16)
    size = struct.unpack_from("<I", b, 4)[0]
    order = ">" if bits & 1 else "<"
    if cls == 0:  # fixed-point
        offset, precision = struct.unpack_from("<HH", b, 8)
        kind = "i" if bits & 0x8 else "u"
        if size not in (1, 2, 4, 8) or offset != 0 or precision != 8 * size or bits & 0x6:
            raise UnsupportedHDF5(f"fixed-point type of size {size}, offset {offset}, precision {precision}")
        return np.dtype(f"{order}{kind}{size}")
    if cls == 1:  # IEEE floating point
        offset, precision, e_loc, e_size, m_loc, m_size, bias = struct.unpack_from("<HHBBBBI", b, 8)
        want = {4: (0, 32, 23, 8, 0, 23, 127, 31), 8: (0, 64, 52, 11, 0, 52, 1023, 63)}.get(size)
        got = (offset, precision, e_loc, e_size, m_loc, m_size, bias, (bits >> 8) & 0xFF)
        if got != want or (bits >> 4) & 0x3 != 2 or bits & 0xE:
            raise UnsupportedHDF5(f"a floating-point type other than IEEE float32/float64 (size {size})")
        return np.dtype(f"{order}f{size}")
    if cls == 8:  # enum: h5py's bool is {FALSE: 0, TRUE: 1} over int8
        n = bits & 0xFFFF
        base = _parse_datatype(b[8:])
        if version not in (1, 2) or size != 1 or base.itemsize != 1 or n != 2:
            raise UnsupportedHDF5("an enum other than h5py's bool")
        p, names = 8 + 12, []
        for _ in range(n):
            end = b.index(b"\0", p)
            names.append(b[p:end].decode())
            p += _pad8(end - p + 1)
        values = list(b[p:p + n])
        if dict(zip(names, values)) != {"FALSE": 0, "TRUE": 1}:
            raise UnsupportedHDF5(f"an enum other than h5py's bool: {dict(zip(names, values))}")
        return np.dtype(np.bool_)
    raise UnsupportedHDF5(f"datatype class {cls} (only fixed-point, float and h5py's bool enum are read)")


def _parse_dataspace(b: bytes) -> Tuple[int, ...]:
    version, rank = b[0], b[1]
    if version == 1:
        dims_at = 8
    elif version == 2:
        if b[3] == 2:
            raise UnsupportedHDF5("a null dataspace")
        dims_at = 4
    else:
        raise UnsupportedHDF5(f"dataspace version {version}")
    return tuple(struct.unpack_from(f"<{rank}Q", b, dims_at))


class _Node:
    def __init__(self, file: "File", name: str):
        self.file, self.name = file, name


class Dataset(_Node):
    """A dataset: ``shape``, ``dtype``; ``ds[()]`` reads it whole (a numpy
    array, or a numpy scalar for a scalar dataspace)."""

    def __init__(self, file, name, shape, dtype, addr=None, data=None):
        super().__init__(file, name)
        self.shape, self.dtype = tuple(shape), np.dtype(dtype)
        self._addr, self._data = addr, data

    @property
    def size(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64))

    def __len__(self):
        return self.shape[0]

    def _read(self) -> np.ndarray:
        if self._data is not None:
            return self._data.copy()
        n = self.size * self.dtype.itemsize
        if self._addr is None:
            if n:
                raise UnsupportedHDF5(f"{self.name}: storage never allocated")
            return np.empty(self.shape, self.dtype)
        if self.dtype == np.bool_:
            raw = np.frombuffer(bytearray(self.file._reader.read(self._addr, n)), np.uint8)
            if raw.size and raw.max() > 1:
                raise UnsupportedHDF5(f"{self.name}: bool enum holds values other than 0 and 1")
            return raw.view(np.bool_).reshape(self.shape)
        return np.frombuffer(bytearray(self.file._reader.read(self._addr, n)), self.dtype).reshape(self.shape)

    def __getitem__(self, key):
        arr = self._read()
        if key == () or key is Ellipsis:
            return arr[()]
        return arr[key]

    def __array__(self, dtype=None, copy=None):
        arr = self._read()
        return arr if dtype is None else arr.astype(dtype)

    def __repr__(self):
        return f'<h5 dataset "{self.name}": shape {self.shape}, type "{self.dtype.str}">'


class _Unsupported(_Node):
    """A member outside the subset: every use raises its error."""

    def __init__(self, file, name, error: UnsupportedHDF5):
        super().__init__(file, name)
        self.error = error

    def __getattr__(self, attr):
        raise self.error

    def __getitem__(self, key):
        raise self.error


class Group(_Node):
    """A group: a mapping of names to groups and datasets, with ``/`` paths."""

    def __init__(self, file, name, members: Optional[Dict[str, "_Node"]] = None, loader=None):
        super().__init__(file, name)
        self._members, self._loader = members, loader

    def _items(self) -> Dict[str, _Node]:
        if self._members is None:
            self._members = self._loader()
        return self._members

    def _child(self, key: str) -> str:
        return f"{self.name.rstrip('/')}/{key}"

    def keys(self):
        return list(self._items().keys())

    def items(self):
        return list(self._items().items())

    def __iter__(self) -> Iterator[str]:
        return iter(self.keys())

    def __len__(self):
        return len(self._items())

    def __contains__(self, path) -> bool:
        try:
            self[path]
        except KeyError:
            return False
        return True

    def __getitem__(self, path: str):
        node = self
        for part in path.strip("/").split("/"):
            if not isinstance(node, Group) or part not in node._items():
                raise KeyError(f"{path!r} is not in {self.name!r}")
            node = node._items()[part]
        return node

    # -------------------------------------------------------------- writing
    def _writable(self):
        if self.file.mode != "w":
            raise ValueError(f"{self.file.filename} is open for reading")

    def _parent_of(self, path: str) -> Tuple["Group", str]:
        parts = path.strip("/").split("/")
        node = self
        for part in parts[:-1]:
            node = node[part] if part in node._items() else node.create_group(part)
        return node, parts[-1]

    def create_group(self, path: str) -> "Group":
        self._writable()
        parent, name = self._parent_of(path)
        if name in parent._items():
            raise ValueError(f"{path!r} already exists in {self.name!r}")
        g = Group(self.file, parent._child(name), {})
        parent._items()[name] = g
        return g

    def require_group(self, path: str) -> "Group":
        return self[path] if path in self else self.create_group(path)

    def create_dataset(self, path: str, data=None) -> Dataset:
        """A dataset holding ``data`` (anything ``np.asarray`` takes), written
        to the file at once."""
        self._writable()
        parent, name = self._parent_of(path)
        if name in parent._items():
            raise ValueError(f"{path!r} already exists in {self.name!r}")
        arr = np.asarray(data)
        if arr.dtype != np.bool_ and arr.dtype.newbyteorder("=") not in _INT_TYPES + [np.dtype("f4"), np.dtype("f8")]:
            raise TypeError(f"{path}: dtype {arr.dtype} is outside the supported subset "
                            "(bool, int8-64, uint8-64, float32, float64)")
        ds = Dataset(self.file, parent._child(name), arr.shape, arr.dtype, addr=self.file._append(arr))
        parent._items()[name] = ds
        return ds

    def __repr__(self):
        return f'<h5 group "{self.name}" ({len(self)} members)>'


def copy(source, dest: Group, name: str):
    """Copy a group (recursively) or a dataset of any open file into
    ``dest`` under ``name`` (h5py's ``Group.copy``)."""
    if isinstance(source, Dataset):
        return dest.create_dataset(name, data=source[()])
    g = dest.create_group(name)
    for key, child in source.items():
        copy(child, g, key)
    return g


class File(Group):
    """An HDF5 file opened for reading (``"r"``) or written anew (``"w"``)."""

    def __init__(self, path, mode: str = "r"):
        if mode not in ("r", "w"):
            raise ValueError(f"mode {mode!r}: only 'r' and 'w' are supported")
        self.filename, self.mode = os.fspath(path), mode
        self._reader, self._out = None, None
        if mode == "r":
            self._reader = _Reader(self.filename)  # closes its file if it refuses the superblock
            super().__init__(self, "/", loader=lambda: self._load_group(self._reader.root_addr, "/"))
        else:
            self._out = open(self.filename, "w+b")
            self._out.write(b"\0" * 96)  # the superblock, written by flush
            super().__init__(self, "/", {})

    # -------------------------------------------------------------- reading
    def _load_group(self, addr: int, name: str) -> Dict[str, _Node]:
        msgs = dict(self._reader.messages(addr))
        stab = msgs.get(MSG_SYMBOL_TABLE)
        if stab is None:
            self._refuse(msgs, name)
            raise UnsupportedHDF5(f"{name}: a group without a symbol table")
        btree, heap = struct.unpack_from("<QQ", stab)
        members = {}
        for key, header in self._reader.group_entries(btree, heap):
            path = f"{name.rstrip('/')}/{key}"
            try:
                members[key] = self._load(header, path)
            except UnsupportedHDF5 as e:  # listed, but refused when read
                members[key] = _Unsupported(self, path, e)
        return members

    @staticmethod
    def _refuse(msgs, name):
        for mtype, why in _REFUSED.items():
            if mtype in msgs:
                raise UnsupportedHDF5(f"{name}: {why}")

    def _load(self, addr: int, name: str) -> _Node:
        msgs = dict(self._reader.messages(addr))
        self._refuse(msgs, name)
        if MSG_SYMBOL_TABLE in msgs:
            return Group(self, name, loader=lambda: self._load_group(addr, name))
        if MSG_LAYOUT not in msgs:
            raise UnsupportedHDF5(f"{name}: an object that is neither a symbol-table group nor a dataset")
        layout = msgs[MSG_LAYOUT]
        if layout[0] != 3:
            raise UnsupportedHDF5(f"{name}: layout message version {layout[0]}")
        if layout[1] != 1:
            kind = {0: "compact", 2: "chunked"}.get(layout[1], f"class {layout[1]}")
            raise UnsupportedHDF5(f"{name}: {kind} storage (only contiguous is read)")
        data_addr, size = struct.unpack_from("<QQ", layout, 2)
        shape = _parse_dataspace(msgs[MSG_DATASPACE])
        dtype = _parse_datatype(msgs[MSG_DATATYPE])
        if data_addr != UNDEF and size != int(np.prod(shape, dtype=np.int64)) * dtype.itemsize:
            raise UnsupportedHDF5(f"{name}: {size} bytes of storage for shape {shape} of {dtype}")
        return Dataset(self, name, shape, dtype, addr=None if data_addr == UNDEF else data_addr)

    # -------------------------------------------------------------- writing
    def _append(self, arr: np.ndarray) -> Optional[int]:
        """Write ``arr``'s bytes at the end of the file; its address (None
        for no bytes)."""
        if arr.nbytes == 0:
            return None
        out = self._out
        out.seek(0, os.SEEK_END)
        addr = out.tell()
        out.write(np.ascontiguousarray(arr).reshape(-1).view(np.uint8).data)
        return addr

    def flush(self):
        """Write the metadata of everything created so far and the
        superblock, so that the file on disk is whole. Data created later
        is appended after it (the metadata written here stays as unused
        bytes)."""
        if self._out is None:
            return
        w = _MetaWriter(self._out)
        root_header, root_btree, root_heap = w.group(self)
        eof = w.finish()
        sb = bytearray(SIGNATURE)
        sb += bytes([0, 0, 0, 0, 0, 8, 8, 0])
        sb += struct.pack("<HHI", LEAF_K, INTERNAL_K, 0)
        sb += struct.pack("<QQQQ", 0, UNDEF, eof, UNDEF)
        sb += _entry_bytes(0, root_header, 1, root_btree, root_heap)
        self._out.seek(0)
        self._out.write(bytes(sb))
        self._out.flush()

    def close(self):
        if self._out is not None:
            self.flush()
            self._out.close()
            self._out = None
        if self._reader is not None:
            self._reader.f.close()
            self._reader = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


# ============================================================================
# metadata writer
# ============================================================================
def _entry_bytes(name_off: int, header: int, cache: int = 0, btree: int = 0, heap: int = 0) -> bytes:
    return struct.pack("<QQII", name_off, header, cache, 0) + struct.pack("<QQ", btree, heap)


def _message(mtype: int, data: bytes, flags: int = 0) -> bytes:
    data = data + b"\0" * (_pad8(len(data)) - len(data))
    return struct.pack("<HHB3x", mtype, len(data), flags) + data


def _object_header(messages: List[bytes]) -> bytes:
    body = b"".join(messages)
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body


def _datatype_bytes(dtype: np.dtype) -> bytes:
    if dtype == np.bool_:  # h5py's bool: enum {FALSE: 0, TRUE: 1} over int8
        base = _datatype_bytes(np.dtype("i1"))
        names = b"FALSE\0\0\0" + b"TRUE\0\0\0\0"
        return struct.pack("<BBBBI", 0x18, 2, 0, 0, 1) + base + names + bytes([0, 1])
    order = 1 if dtype.byteorder == ">" else 0
    size = dtype.itemsize
    if dtype.kind in "iu":
        bits = order | (0x8 if dtype.kind == "i" else 0)
        return struct.pack("<BBBBIHH", 0x10, bits, 0, 0, size, 0, 8 * size)
    sign, e_loc, e_size, m_size, bias = (31, 23, 8, 23, 127) if size == 4 else (63, 52, 11, 52, 1023)
    return struct.pack("<BBBBIHHBBBBI", 0x11, order | 0x20, sign, 0, size, 0, 8 * size, e_loc, e_size, 0,
                       m_size, bias)


def _dataspace_bytes(shape: Tuple[int, ...]) -> bytes:
    # version 1; the maximum dims (equal to the dims) follow, as HDF5 writes them
    flags = 1 if shape else 0
    dims = struct.pack(f"<{len(shape)}Q", *shape)
    return struct.pack("<BBBB4x", 1, len(shape), flags, 0) + dims + (dims if shape else b"")


# fill value message version 2 as h5py writes it: allocated late, written if
# set, the default value (defined, of size 0)
_FILL_V2 = bytes([2, 2, 2, 1, 0, 0, 0, 0])


class _MetaWriter:
    """Appends the metadata of a group tree at the end of the file."""

    def __init__(self, out):
        self.out = out
        out.seek(0, os.SEEK_END)
        self.start = out.tell()
        self.buf = bytearray()

    def alloc(self, n: int) -> int:
        """Room for ``n`` bytes (8-aligned) at the end of what is queued."""
        pad = (-(self.start + len(self.buf))) % 8
        self.buf += b"\0" * pad
        addr = self.start + len(self.buf)
        self.buf += b"\0" * n
        return addr

    def put(self, addr: int, data: bytes):
        off = addr - self.start
        self.buf[off:off + len(data)] = data

    def dataset(self, ds: Dataset) -> int:
        layout = struct.pack("<BBQQ", 3, 1, UNDEF if ds._addr is None else ds._addr, ds.size * ds.dtype.itemsize)
        header = _object_header([
            _message(MSG_DATASPACE, _dataspace_bytes(ds.shape)),
            _message(MSG_DATATYPE, _datatype_bytes(ds.dtype), flags=1),
            _message(MSG_FILL, _FILL_V2, flags=1),
            _message(MSG_LAYOUT, layout),
        ])
        addr = self.alloc(len(header))
        self.put(addr, header)
        return addr

    def group(self, group: Group) -> Tuple[int, int, int]:
        """Write ``group`` and everything under it; (object header, B-tree,
        heap) addresses."""
        members = sorted(group._items().items(), key=lambda kv: kv[0].encode())
        entries = []
        for name, node in members:
            if isinstance(node, Group):
                header, btree, heap = self.group(node)
                entries.append((name, header, 1, btree, heap))
            else:
                entries.append((name, self.dataset(node), 0, 0, 0))

        # local heap: "" at offset 0, then each name, 8-byte aligned
        heap_data, offsets = bytearray(b"\0" * 8), []
        for name, *_ in entries:
            offsets.append(len(heap_data))
            raw = name.encode() + b"\0"
            heap_data += raw + b"\0" * (_pad8(len(raw)) - len(raw))
        heap_addr = self.alloc(32)
        data_addr = self.alloc(len(heap_data))
        self.put(heap_addr, b"HEAP" + bytes(4) + struct.pack("<QQQ", len(heap_data), 1, data_addr))
        self.put(data_addr, bytes(heap_data))

        # symbol table nodes of up to 2 LEAF_K entries; (lo, hi) key offsets
        level: List[Tuple[int, int, int]] = []
        lo = 0
        for i in range(0, len(entries), 2 * LEAF_K):
            chunk = entries[i:i + 2 * LEAF_K]
            addr = self.alloc(SNOD_SIZE)
            body = b"".join(_entry_bytes(offsets[i + j], *e[1:]) for j, e in enumerate(chunk))
            self.put(addr, b"SNOD" + struct.pack("<BBH", 1, 0, len(chunk)) + body)
            hi = offsets[i + len(chunk) - 1]
            level.append((addr, lo, hi))
            lo = hi
        # B-tree levels of up to 2 INTERNAL_K children, up to one root (an
        # empty group: a root with no children)
        depth = 0
        while depth == 0 or len(level) > 1:
            nodes = [level[i:i + 2 * INTERNAL_K] for i in range(0, len(level), 2 * INTERNAL_K)] or [[]]
            addrs = [self.alloc(BTREE_SIZE) for _ in nodes]
            parents = []
            for k, (addr, kids) in enumerate(zip(addrs, nodes)):
                left = addrs[k - 1] if k > 0 else UNDEF
                right = addrs[k + 1] if k + 1 < len(addrs) else UNDEF
                lo, hi = (kids[0][1], kids[-1][2]) if kids else (0, 0)
                body = struct.pack("<Q", lo)
                for child, _, child_hi in kids:
                    body += struct.pack("<QQ", child, child_hi)
                self.put(addr, b"TREE" + struct.pack("<BBHQQ", 0, depth, len(kids), left, right) + body)
                parents.append((addr, lo, hi))
            level, depth = parents, depth + 1
        btree_addr = level[0][0]

        header = _object_header([_message(MSG_SYMBOL_TABLE, struct.pack("<QQ", btree_addr, heap_addr))])
        header_addr = self.alloc(len(header))
        self.put(header_addr, header)
        return header_addr, btree_addr, heap_addr

    def finish(self) -> int:
        """Write the queued metadata; the file's end address."""
        self.out.seek(self.start)
        self.out.write(bytes(self.buf))
        return self.start + len(self.buf)
