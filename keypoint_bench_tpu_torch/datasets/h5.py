"""Read-only HDF5 datasets in numpy, without h5py: the port's counterpart
of the JAX loaders' `np.array(h5py.File(path)[name])`, for MegaDepth's
depth maps (`/depth`) and calibrations (`K`, `R`, `T`).

`File(path)[name]` returns the dataset as a numpy array of the file's
dtype (byte order included) and shape, the array h5py gives. The scope is
what h5py writes with libver "earliest" and "latest":
- superblock versions 0, 2 and 3 (1, which h5py does not write, is
  read as 0 with its four more bytes); a user block before it is
  skipped;
- object headers v1, and v2 (OHDR) with continuation blocks;
- groups as a symbol table (v1 B-tree, local heap, SNOD) or as link
  messages (compact storage), hard links only;
- dataspace scalar or simple;
- datatype fixed-point (1, 2, 4, 8 bytes) and IEEE floating-point (2, 4,
  8 bytes), little- or big-endian;
- layout compact, contiguous or chunked, chunks indexed by a v1 B-tree
  (earliest) or by a single-chunk, implicit or fixed-array index (latest);
- filters deflate, shuffle and fletcher32 (its checksum is verified);
- an unallocated dataset or chunk reads as its fill value (zeros unless
  the file sets one).
Anything else (an extensible-array or v2 B-tree chunk index, dense link
storage, a shared datatype, szip, lzf, strings, compounds, ...) raises
ValueError naming what it met. Metadata checksums are not verified.
"""
from __future__ import annotations

import zlib

import numpy as np

_SIGNATURE = b"\x89HDF\r\n\x1a\n"
_DATATYPE_CLASSES = {0: "fixed-point", 1: "floating-point", 2: "time",
                     3: "string", 4: "bitfield", 5: "opaque",
                     6: "compound", 7: "reference", 8: "enum",
                     9: "variable-length", 10: "array"}
# (bit offset, precision, exponent location, exponent size, mantissa
# location, mantissa size, exponent bias) of the IEEE types numpy has
_IEEE = {2: (0, 16, 10, 5, 0, 10, 15), 4: (0, 32, 23, 8, 0, 23, 127),
         8: (0, 64, 52, 11, 0, 52, 1023)}
_FILTERS = {1: "deflate", 2: "shuffle", 3: "fletcher32", 4: "szip",
            5: "nbit", 6: "scaleoffset", 307: "bzip2", 32000: "lzf",
            32001: "blosc", 32004: "lz4", 32015: "zstd"}
_CHUNK_INDEXES = {1: "single chunk", 2: "implicit", 3: "fixed array",
                  4: "extensible array", 5: "v2 B-tree"}
# message types
_DATASPACE, _LINK_INFO, _DATATYPE, _FILL_OLD, _FILL = 0x01, 0x02, 0x03, \
    0x04, 0x05
_LINK, _LAYOUT, _FILTER_PIPELINE, _CONTINUATION, _SYMBOL_TABLE = 0x06, \
    0x08, 0x0B, 0x10, 0x11


def fletcher32(data: bytes) -> int:
    """HDF5's Fletcher-32 (H5_checksum_fletcher32): big-endian 16-bit
    words, both sums folded every 360 words."""
    n = len(data)
    words = np.frombuffer(data[:n - n % 2], ">u2").astype(np.int64)
    s1 = s2 = 0
    for i in range(0, len(words), 360):
        block = words[i:i + 360]
        c = np.cumsum(block)
        s2 = (s2 + len(block) * s1 + int(c.sum())) & 0xFFFFFFFF
        s1 = (s1 + int(c[-1])) & 0xFFFFFFFF
        s1 = (s1 & 0xFFFF) + (s1 >> 16)
        s2 = (s2 & 0xFFFF) + (s2 >> 16)
    if n % 2:
        s1 += data[-1] << 8
        s2 += s1
        s1 = (s1 & 0xFFFF) + (s1 >> 16)
        s2 = (s2 & 0xFFFF) + (s2 >> 16)
    s1 = (s1 & 0xFFFF) + (s1 >> 16)
    s2 = (s2 & 0xFFFF) + (s2 >> 16)
    return (s2 << 16) | s1


def _unshuffle(data: bytes, size: int) -> bytes:
    n = len(data) // size
    if size <= 1 or n == 0:
        return data
    body = np.frombuffer(data[:n * size], np.uint8).reshape(size, n)
    return body.T.tobytes() + data[n * size:]


class File:
    """An HDF5 file read whole into memory; `f[name]` is a dataset as a
    numpy array, `f.keys()` the names in the root group."""

    def __init__(self, path):
        self.path = str(path)
        with open(path, "rb") as fh:
            self._buf = fh.read()
        self._superblock()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        self._buf = b""

    def keys(self):
        return list(self._links(self._root))

    def __getitem__(self, name: str) -> np.ndarray:
        addr = self._root
        for part in (p for p in name.split("/") if p):
            links = self._links(addr)
            if part not in links:
                raise KeyError(f"{self.path}: no object {name!r}")
            addr = links[part]
            if isinstance(addr, str):
                raise ValueError(f"{self.path}: {name!r} is a {addr}; only "
                                 f"hard links are read")
        return self._dataset(addr, name)

    # -- primitives --------------------------------------------------------

    def _u(self, pos: int, n: int) -> int:
        if pos < 0 or pos + n > len(self._buf):
            raise ValueError(f"{self.path}: truncated at byte {pos}")
        return int.from_bytes(self._buf[pos:pos + n], "little")

    def _addr(self, pos: int) -> int:
        """The file address stored at pos, absolute; None if undefined."""
        self._u(pos, self._o)
        return self._addr_of(self._buf[pos:pos + self._o])

    def _addr_of(self, raw: bytes):
        a = int.from_bytes(raw[:self._o], "little")
        return None if a == self._undef else self._base + a

    def _expect(self, pos: int, sig: bytes, what: str):
        if self._buf[pos:pos + len(sig)] != sig:
            raise ValueError(f"{self.path}: no {what} signature {sig!r} at "
                             f"byte {pos}")

    def _superblock(self):
        pos = 0
        while self._buf[pos:pos + 8] != _SIGNATURE:
            pos = 512 if pos == 0 else 2 * pos
            if pos + 8 > len(self._buf):
                raise ValueError(f"{self.path} is not an HDF5 file (no "
                                 f"superblock signature)")
        version = self._buf[pos + 8]
        if version in (0, 1):
            self._o, self._l = self._buf[pos + 13], self._buf[pos + 14]
            p = pos + 24 + (4 if version == 1 else 0)
        elif version in (2, 3):
            self._o, self._l = self._buf[pos + 9], self._buf[pos + 10]
            p = pos + 12
        else:
            raise ValueError(f"{self.path}: superblock version {version}")
        o = self._o
        self._undef = (1 << (8 * o)) - 1
        self._base = self._u(p, o)
        if version in (0, 1):
            # four addresses (base, free space, end of file, VFD info),
            # then the root group's symbol table entry (name offset,
            # header address)
            self._root = self._addr(p + 4 * o + o)
        else:
            # base, superblock extension, end of file, root group header
            self._root = self._addr(p + 3 * o)

    # -- object headers ----------------------------------------------------

    def _messages(self, addr: int):
        """[(type, flags, data)] of the object header at addr, over its
        continuation blocks."""
        if self._buf[addr:addr + 4] == b"OHDR":
            return self._messages_v2(addr)
        if self._buf[addr] != 1:
            raise ValueError(f"{self.path}: object header version "
                             f"{self._buf[addr]} at byte {addr}")
        blocks = [(addr + 16, self._u(addr + 8, 4))]
        out = []
        while blocks:
            p, size = blocks.pop(0)
            end = p + size
            while p + 8 <= end:
                mtype, msize = self._u(p, 2), self._u(p + 2, 2)
                flags = self._buf[p + 4]
                data = self._buf[p + 8:p + 8 + msize]
                p += 8 + msize
                if mtype == _CONTINUATION:
                    blocks.append(self._continuation(data))
                elif mtype:
                    out.append((mtype, flags, data))
        return out

    def _continuation(self, data):
        return (self._addr_of(data),
                int.from_bytes(data[self._o:self._o + self._l], "little"))

    def _messages_v2(self, addr: int):
        version, hflags = self._buf[addr + 4], self._buf[addr + 5]
        if version != 2:
            raise ValueError(f"{self.path}: OHDR version {version}")
        p = addr + 6 + (16 if hflags & 0x20 else 0) + (4 if hflags & 0x10
                                                        else 0)
        n = 1 << (hflags & 3)
        blocks = [(p + n, self._u(p, n))]
        head = 6 if hflags & 0x04 else 4      # creation order stored
        out, first = [], True
        while blocks:
            p, size = blocks.pop(0)
            if not first:
                self._expect(p, b"OCHK", "continuation block")
                p, size = p + 4, size - 8       # signature, checksum
            first = False
            end = p + size
            while p + head <= end:
                mtype, msize = self._buf[p], self._u(p + 1, 2)
                flags = self._buf[p + 3]
                data = self._buf[p + head:p + head + msize]
                p += head + msize
                if mtype == _CONTINUATION:
                    blocks.append(self._continuation(data))
                elif mtype:
                    out.append((mtype, flags, data))
        return out

    # -- groups ------------------------------------------------------------

    def _links(self, addr: int) -> dict:
        """name -> object header address (or the kind of a link that is
        not hard) of the group at addr."""
        links = {}
        for mtype, _, d in self._messages(addr):
            if mtype == _SYMBOL_TABLE:
                links.update(self._symbol_table(self._addr_of(d),
                                                self._addr_of(d[self._o:])))
            elif mtype == _LINK:
                name, target = self._link(d)
                links[name] = target
            elif mtype == _LINK_INFO:
                if self._addr_of(d[2 + (8 if d[1] & 1 else 0):]) is not None:
                    raise ValueError(f"{self.path}: a group with dense link "
                                     f"storage (fractal heap)")
        return links

    def _symbol_table(self, btree: int, heap: int) -> dict:
        self._expect(heap, b"HEAP", "local heap")
        data = self._addr(heap + 8 + 2 * self._l)
        o = self._o
        links, nodes = {}, [btree]
        while nodes:
            p = nodes.pop()
            self._expect(p, b"TREE", "v1 B-tree node")
            level, used = self._buf[p + 5], self._u(p + 6, 2)
            p += 8 + 2 * o + self._l             # siblings, first key
            for _ in range(used):
                child = self._addr(p)
                p += o + self._l
                if level:
                    nodes.append(child)
                    continue
                self._expect(child, b"SNOD", "symbol table node")
                q = child + 8
                for _ in range(self._u(child + 6, 2)):
                    off = self._u(q, o)
                    end = self._buf.index(b"\0", data + off)
                    links[self._buf[data + off:end].decode()] = \
                        self._addr(q + o)
                    q += 2 * o + 24
        return links

    def _link(self, d: bytes):
        flags, p = d[1], 2
        kind = 0
        if flags & 0x08:
            kind, p = d[p], p + 1
        p += (8 if flags & 0x04 else 0) + (1 if flags & 0x10 else 0)
        n = 1 << (flags & 3)
        length = int.from_bytes(d[p:p + n], "little")
        name = d[p + n:p + n + length].decode()
        if kind != 0:
            return name, {1: "soft link", 64: "external link"}.get(
                kind, f"link of type {kind}")
        return name, self._addr_of(d[p + n + length:])

    # -- datasets ----------------------------------------------------------

    def _dataset(self, addr: int, name: str) -> np.ndarray:
        shape = dtype = layout = None
        filters, fill = [], None
        for mtype, flags, d in self._messages(addr):
            if flags & 0x02 and mtype in (_DATASPACE, _DATATYPE, _FILL,
                                          _FILL_OLD, _LAYOUT,
                                          _FILTER_PIPELINE):
                raise ValueError(f"{self.path}: {name!r} has a shared "
                                 f"message (type {mtype:#x}), e.g. a "
                                 f"committed datatype")
            if mtype == _DATASPACE:
                shape = self._dataspace(d, name)
            elif mtype == _DATATYPE:
                dtype = self._datatype(d, name)
            elif mtype == _LAYOUT:
                layout = d
            elif mtype == _FILTER_PIPELINE:
                filters = self._filters(d, name)
            elif mtype == _FILL:
                fill = self._fill(d)
            elif mtype == _FILL_OLD and fill is None:
                fill = d[4:4 + int.from_bytes(d[:4], "little")]
        if shape is None or dtype is None or layout is None:
            raise ValueError(f"{self.path}: {name!r} is not a dataset")
        out = np.zeros(shape, dtype)
        if fill and len(fill) == dtype.itemsize:
            out[...] = np.frombuffer(fill, dtype)[0]
        version, cls = layout[0], layout[1]
        if version not in (3, 4):
            raise ValueError(f"{self.path}: {name!r} has a layout message of "
                             f"version {version}")
        if cls == 0:                            # compact
            return self._array(layout, 4, dtype, shape, name)
        if cls == 1:                            # contiguous
            a = self._addr_of(layout[2:])
            return out if a is None else self._array(self._buf, a, dtype,
                                                     shape, name)
        if cls == 2:
            self._chunked(layout, out, filters, name)
            return out
        kind = "virtual" if cls == 3 else f"class {cls}"
        raise ValueError(f"{self.path}: {name!r} has a {kind} layout")

    def _array(self, buf, offset, dtype, shape, name):
        count = int(np.prod(shape, dtype=np.int64))
        if offset + count * dtype.itemsize > len(buf):
            raise ValueError(f"{self.path}: {name!r} is truncated")
        return np.frombuffer(buf, dtype, count, offset).reshape(shape).copy()

    def _dataspace(self, d: bytes, name: str):
        version, rank = d[0], d[1]
        if version == 1:
            p = 8
        elif version == 2:
            if d[3] == 2:
                raise ValueError(f"{self.path}: {name!r} has a null "
                                 f"dataspace")
            p = 4
        else:
            raise ValueError(f"{self.path}: dataspace version {version}")
        return tuple(int.from_bytes(d[p + i * self._l:p + (i + 1) * self._l],
                                    "little") for i in range(rank))

    def _datatype(self, d: bytes, name: str) -> np.dtype:
        cls, bits = d[0] & 0x0F, int.from_bytes(d[1:4], "little")
        size = int.from_bytes(d[4:8], "little")
        order = ">" if bits & 1 else "<"
        props = [int.from_bytes(d[8:10], "little"),
                 int.from_bytes(d[10:12], "little")]
        if cls == 0 and size in (1, 2, 4, 8) and props == [0, 8 * size]:
            return np.dtype(f"{order}{'i' if bits & 8 else 'u'}{size}")
        if cls == 1 and size in _IEEE and not bits & 0x40:
            props += list(d[12:16]) + [int.from_bytes(d[16:20], "little")]
            if (tuple(props) == _IEEE[size] and (bits >> 8) & 0xFF
                    == 8 * size - 1 and (bits >> 4) & 3 == 2):
                return np.dtype(f"{order}f{size}")
        what = _DATATYPE_CLASSES.get(cls, f"class {cls}")
        raise ValueError(f"{self.path}: {name!r} has a {size}-byte {what} "
                         f"datatype that is not read here")

    def _fill(self, d: bytes):
        """The fill value's bytes from a fill value message, or None."""
        version = d[0]
        if version == 1:
            return d[8:8 + int.from_bytes(d[4:8], "little")]
        if version == 2:
            return d[8:8 + int.from_bytes(d[4:8], "little")] if d[3] \
                else None
        if version == 3 and d[1] & 0x20:
            return d[6:6 + int.from_bytes(d[2:6], "little")]
        return None

    def _filters(self, d: bytes, name: str):
        version, count = d[0], d[1]
        p = 8 if version == 1 else 2
        out = []
        for _ in range(count):
            fid = int.from_bytes(d[p:p + 2], "little")
            if version == 1 or fid >= 256:
                nlen = int.from_bytes(d[p + 2:p + 4], "little")
                p += 4
            else:
                nlen, p = 0, p + 2
            nvals = int.from_bytes(d[p + 2:p + 4], "little")
            p += 4
            label = d[p:p + nlen].split(b"\0")[0].decode(errors="replace")
            p += (-(-nlen // 8) * 8) if version == 1 else nlen
            vals = [int.from_bytes(d[p + 4 * i:p + 4 * i + 4], "little")
                    for i in range(nvals)]
            p += 4 * nvals + (4 if version == 1 and nvals % 2 else 0)
            if fid not in (1, 2, 3):
                raise ValueError(
                    f"{self.path}: {name!r} uses filter {fid} "
                    f"({_FILTERS.get(fid, label or 'unknown')}); only "
                    f"deflate, shuffle and fletcher32 are read here")
            out.append((fid, vals))
        return out

    def _unfilter(self, raw: bytes, filters, mask: int, itemsize: int,
                  name: str) -> bytes:
        for i in reversed(range(len(filters))):
            if mask >> i & 1:
                continue
            fid, vals = filters[i]
            if fid == 1:
                raw = zlib.decompress(raw)
            elif fid == 2:
                raw = _unshuffle(raw, vals[0] if vals else itemsize)
            else:
                body, stored = raw[:-4], int.from_bytes(raw[-4:], "little")
                if fletcher32(body) != stored:
                    raise ValueError(f"{self.path}: {name!r} fails its "
                                     f"fletcher32 checksum")
                raw = body
        return raw

    # -- chunks ------------------------------------------------------------

    def _chunked(self, layout: bytes, out: np.ndarray, filters, name):
        """Fill `out` from the chunks that exist; the rest keeps the fill
        value."""
        o, rank = self._o, out.ndim
        if layout[0] == 3:
            ndims = layout[2]
            index = self._addr_of(layout[3:3 + o])
            p = 3 + o
            dims = [int.from_bytes(layout[p + 4 * i:p + 4 * i + 4], "little")
                    for i in range(ndims)]
            chunks = [] if index is None else self._btree_chunks(index,
                                                                 ndims)
            partial_raw = False
        else:
            lflags, ndims, enc = layout[2], layout[3], layout[4]
            dims = [int.from_bytes(layout[5 + i * enc:5 + (i + 1) * enc],
                                   "little") for i in range(ndims)]
            p = 5 + ndims * enc
            kind, p = layout[p], p + 1
            partial_raw = bool(lflags & 1)
            chunks = self._indexed_chunks(kind, layout, p, lflags, out,
                                          dims[:rank], filters, name)
        cshape = tuple(dims[:rank])
        csize = int(np.prod(cshape, dtype=np.int64)) * out.dtype.itemsize
        for offs, addr, nbytes, mask in chunks:
            raw = self._buf[addr:addr + nbytes]
            edge = any(a + c > s for a, c, s in zip(offs, cshape,
                                                    out.shape))
            if filters and not (partial_raw and edge):
                raw = self._unfilter(raw, filters, mask, out.dtype.itemsize,
                                     name)
            if len(raw) < csize:
                raise ValueError(f"{self.path}: a chunk of {name!r} is "
                                 f"truncated")
            chunk = np.frombuffer(raw, out.dtype, csize // out.dtype.itemsize
                                  ).reshape(cshape)
            dst = tuple(slice(a, min(a + c, s)) for a, c, s in
                        zip(offs, cshape, out.shape))
            out[dst] = chunk[tuple(slice(0, d.stop - d.start) for d in dst)]

    def _btree_chunks(self, addr: int, ndims: int):
        """(offsets, address, bytes, filter mask) of every chunk under a v1
        B-tree of raw-data chunks."""
        o, key = self._o, 8 + 8 * ndims
        out, nodes = [], [addr]
        while nodes:
            p = nodes.pop()
            self._expect(p, b"TREE", "v1 B-tree node")
            level, used = self._buf[p + 5], self._u(p + 6, 2)
            p += 8 + 2 * o
            for _ in range(used):
                nbytes, mask = self._u(p, 4), self._u(p + 4, 4)
                offs = tuple(self._u(p + 8 + 8 * i, 8)
                             for i in range(ndims - 1))
                child = self._addr(p + key)
                p += key + o
                if level:
                    nodes.append(child)
                else:
                    out.append((offs, child, nbytes, mask))
        return out

    def _grid(self, shape, cshape):
        """The chunk grid's offsets in row-major order."""
        counts = [-(-s // c) for s, c in zip(shape, cshape)]
        return [tuple(int(i) * c for i, c in zip(idx, cshape))
                for idx in np.ndindex(*counts)]

    def _indexed_chunks(self, kind, layout, p, lflags, out, cshape, filters,
                        name):
        """The chunks of a layout-v4 chunk index."""
        o, l_ = self._o, self._l
        csize = int(np.prod(cshape, dtype=np.int64)) * out.dtype.itemsize
        grid = self._grid(out.shape, cshape)
        if kind == 1:                           # single chunk
            nbytes, mask = csize, 0
            if lflags & 2:
                nbytes = int.from_bytes(layout[p:p + l_], "little")
                mask = int.from_bytes(layout[p + l_:p + l_ + 4], "little")
                p += l_ + 4
            addr = self._addr_of(layout[p:p + o])
            return [] if addr is None else [(grid[0], addr, nbytes, mask)]
        if kind == 2:                           # implicit
            addr = self._addr_of(layout[p:p + o])
            return [] if addr is None else [
                (off, addr + i * csize, csize, 0)
                for i, off in enumerate(grid)]
        if kind == 3:                           # fixed array
            addr = self._addr_of(layout[p + 1:p + 1 + o])
            return [] if addr is None else self._fixed_array(
                addr, grid, csize, bool(filters))
        raise ValueError(f"{self.path}: {name!r} has a "
                         f"{_CHUNK_INDEXES.get(kind, f'type {kind}')} chunk "
                         f"index")

    def _fixed_array(self, addr, grid, csize, filtered):
        o = self._o
        self._expect(addr, b"FAHD", "fixed array header")
        entry, page_bits = self._buf[addr + 6], self._buf[addr + 7]
        count = self._u(addr + 8, self._l)
        block = self._addr(addr + 8 + self._l)
        if block is None:
            return []
        self._expect(block, b"FADB", "fixed array data block")
        p = block + 6 + o
        page = 1 << page_bits
        pages = [(p, count, True)]
        if count > page:                        # paged: a bitmap, then pages
            npages = -(-count // page)
            bitmap = self._buf[p:p + -(-npages // 8)]
            p += len(bitmap) + 4                # the prefix's checksum
            pages = []
            for k in range(npages):
                n = min(page, count - k * page)
                pages.append((p, n, bool(bitmap[k // 8] & (0x80 >> k % 8))))
                p += n * entry + 4
        out, i = [], 0
        for p, n, init in pages:
            for j in range(n):
                q = p + j * entry
                a = self._addr(q) if init else None
                if a is not None:
                    nbytes, mask = csize, 0
                    if filtered:
                        nbytes = self._u(q + o, entry - o - 4)
                        mask = self._u(q + entry - 4, 4)
                    out.append((grid[i + j], a, nbytes, mask))
            i += n
        return out


def read(path, name: str) -> np.ndarray:
    """The dataset `name` of the HDF5 file at path as a numpy array."""
    with File(path) as f:
        return f[name]
