"""Minimal pure-Python HDF5 reader for netCDF-4 files.

The execution image has no h5py/netCDF4/HDF5 libraries; the reference
links HDF5 natively (libs/build.sh).  This module implements the subset
of HDF5 needed to read netCDF-4 data files: superblock v0/v2/v3, v1/v2
object headers, symbol-table and link-message groups, fixed-point /
floating-point / string datatypes, contiguous and chunked (v1 B-tree)
layouts with optional deflate/shuffle filters, and attributes.

API mirrors the bits of h5py we use:

    f = H5File(path)
    f.datasets            # {name: H5Dataset}
    d = f.datasets["t"]   # .shape, .dtype, .attrs, .read() -> ndarray
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

_SIG = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF


class _Buf:
    def __init__(self, data: bytes):
        self.d = data

    def u(self, off, n):
        return int.from_bytes(self.d[off:off + n], "little")


@dataclass
class H5Dataset:
    name: str
    shape: Tuple[int, ...]
    dtype: np.dtype
    attrs: Dict[str, object]
    _file: "H5File"
    _layout: Tuple  # ("contiguous", addr, size) | ("chunked", btree_addr, chunk_shape) | ("compact", bytes)
    _filters: List[Tuple[int, List[int]]] = field(default_factory=list)
    _fillvalue: Optional[bytes] = None

    def read(self) -> np.ndarray:
        kind = self._layout[0]
        nelem = int(np.prod(self.shape)) if self.shape else 1
        itemsize = self.dtype.itemsize
        if kind == "compact":
            raw = self._layout[1]
            return np.frombuffer(raw[:nelem * itemsize],
                                 self.dtype).reshape(self.shape)
        if kind == "contiguous":
            addr, size = self._layout[1], self._layout[2]
            if addr == UNDEF:
                return self._fill_array(nelem)
            raw = self._file.buf.d[addr:addr + nelem * itemsize]
            return np.frombuffer(raw, self.dtype).reshape(self.shape)
        if kind == "chunked":
            return self._read_chunked()
        raise NotImplementedError(f"layout {kind}")

    def _fill_array(self, nelem):
        if self._fillvalue:
            fv = np.frombuffer(self._fillvalue[:self.dtype.itemsize],
                               self.dtype)[0]
        else:
            fv = 0
        return np.full(self.shape, fv, self.dtype)

    def _read_chunked(self) -> np.ndarray:
        btree_addr, chunk_shape = self._layout[1], self._layout[2]
        out = self._fill_array(int(np.prod(self.shape)))
        if btree_addr == UNDEF:
            return out
        for offsets, addr, size in self._file._iter_chunks(
                btree_addr, len(chunk_shape)):
            raw = self._file.buf.d[addr:addr + size]
            for fid, cd in reversed(self._filters):
                if fid == 1:          # deflate
                    raw = zlib.decompress(raw)
                elif fid == 2:        # shuffle
                    es = cd[0] if cd else self.dtype.itemsize
                    arr = np.frombuffer(raw, np.uint8)
                    n = arr.size // es
                    raw = (arr[:n * es].reshape(es, n).T).tobytes()
                elif fid == 3:        # fletcher32 checksum (trailing 4B)
                    raw = raw[:-4]
                else:
                    raise NotImplementedError(f"HDF5 filter {fid}")
            chunk = np.frombuffer(
                raw, self.dtype,
                count=int(np.prod(chunk_shape))).reshape(chunk_shape)
            # clip chunk into output
            sl_out, sl_in = [], []
            ok = True
            for dim, (o, c, s) in enumerate(
                    zip(offsets, chunk_shape, self.shape)):
                if o >= s:
                    ok = False
                    break
                end = min(o + c, s)
                sl_out.append(slice(o, end))
                sl_in.append(slice(0, end - o))
            if ok:
                out[tuple(sl_out)] = chunk[tuple(sl_in)]
        return out


class H5File:
    def __init__(self, path: str):
        with open(path, "rb") as f:
            self.buf = _Buf(f.read())
        if self.buf.d[:8] != _SIG:
            raise ValueError(f"{path} is not an HDF5 file")
        self.datasets: Dict[str, H5Dataset] = {}
        self.attrs: Dict[str, object] = {}
        self._parse_superblock()
        self._walk_group(self.root_header_addr, prefix="")

    # --- superblock ---
    def _parse_superblock(self):
        b = self.buf
        ver = b.u(8, 1)
        if ver in (0, 1):
            self.size_offsets = b.u(13, 1)
            self.size_lengths = b.u(14, 1)
            off = 24 if ver == 0 else 26
            # base addr, free space, EOF, drv info, root symbol entry
            so = self.size_offsets
            root_sym = off + 4 * so
            # symbol table entry: link name offset, object header addr
            self.root_header_addr = b.u(root_sym + so, so)
        elif ver in (2, 3):
            self.size_offsets = b.u(9, 1)
            self.size_lengths = b.u(10, 1)
            so = self.size_offsets
            self.root_header_addr = b.u(12 + 3 * so, so)
        else:
            raise NotImplementedError(f"superblock v{ver}")

    def _off(self, off):
        return self.buf.u(off, self.size_offsets)

    def _len(self, off):
        return self.buf.u(off, self.size_lengths)

    # --- object headers ---
    def _messages(self, addr) -> List[Tuple[int, bytes]]:
        """Return [(msg_type, payload)] of an object header (v1 or
        v2), following continuation messages."""
        b = self.buf
        msgs = []
        if b.d[addr:addr + 4] == b"OHDR":       # v2
            ver = b.u(addr + 4, 1)
            flags = b.u(addr + 5, 1)
            p = addr + 6
            if flags & 0b100000:
                p += 8  # times
            if flags & 0b10000:
                p += 4  # max compact etc
            size_bytes = 1 << (flags & 0b11)
            size_chunk0 = b.u(p, size_bytes)
            p += size_bytes
            self._parse_msgs_v2(p, size_chunk0, flags, msgs)
        else:                                   # v1
            nmsg = b.u(addr + 2, 2)
            hdr_size = b.u(addr + 8, 4)
            p = addr + 16
            self._parse_msgs_v1(p, hdr_size, nmsg, msgs)
        return msgs

    def _parse_msgs_v1(self, p, size, nmsg, msgs):
        b = self.buf
        end = p + size
        count = 0
        while p < end and count < nmsg:
            mtype = b.u(p, 2)
            msize = b.u(p + 2, 2)
            body = b.d[p + 8:p + 8 + msize]
            p += 8 + msize
            count += 1
            if mtype == 0x10:  # continuation
                caddr = int.from_bytes(body[:self.size_offsets], "little")
                clen = int.from_bytes(
                    body[self.size_offsets:self.size_offsets
                         + self.size_lengths], "little")
                self._parse_msgs_v1(caddr, clen, nmsg - count, msgs)
                # messages in the continuation counted inside
                count = nmsg  # conservative stop for this block
            else:
                msgs.append((mtype, body))

    def _parse_msgs_v2(self, p, size, flags, msgs):
        b = self.buf
        end = p + size
        track_order = bool(flags & 0b100)
        while p + 4 <= end:
            mtype = b.u(p, 1)
            msize = b.u(p + 1, 2)
            p += 4
            if track_order:
                p += 2
            body = b.d[p:p + msize]
            p += msize
            if mtype == 0x10:
                caddr = int.from_bytes(body[:self.size_offsets], "little")
                clen = int.from_bytes(
                    body[self.size_offsets:self.size_offsets
                         + self.size_lengths], "little")
                # v2 continuation blocks start with "OCHK", end with gap+checksum
                self._parse_msgs_v2(caddr + 4, clen - 4 - 4, flags, msgs)
            else:
                msgs.append((mtype, body))

    # --- group traversal ---
    def _walk_group(self, header_addr, prefix):
        msgs = self._messages(header_addr)
        children: List[Tuple[str, int]] = []
        is_dataset = any(m[0] == 0x08 for m in msgs)
        for mtype, body in msgs:
            if mtype == 0x11:  # symbol table (old-style group)
                btree = int.from_bytes(body[:self.size_offsets], "little")
                heap = int.from_bytes(
                    body[self.size_offsets:2 * self.size_offsets],
                    "little")
                children += self._symbol_table_entries(btree, heap)
            elif mtype == 0x06:  # link message (new-style group)
                child = self._parse_link(body)
                if child:
                    children.append(child)
            elif mtype == 0x02:  # link info: fractal heap groups
                children += self._parse_link_info(body)
        if is_dataset:
            ds = self._parse_dataset(prefix.rstrip("/"), msgs)
            if ds is not None:
                self.datasets[ds.name] = ds
        else:
            if prefix == "":
                self.attrs = self._parse_attrs(msgs)
            for name, addr in children:
                self._walk_group(addr, prefix + name + "/")

    def _symbol_table_entries(self, btree_addr, heap_addr):
        b = self.buf
        out = []
        if btree_addr == UNDEF:
            return out
        heap_data_addr = self._off(heap_addr + 8 + 2 * self.size_lengths)

        def walk_btree(addr):
            if b.d[addr:addr + 4] == b"TREE":
                level = b.u(addr + 5, 1)
                nentries = b.u(addr + 6, 2)
                p = addr + 8 + 2 * self.size_offsets
                p += self.size_lengths  # key 0
                for _ in range(nentries):
                    child = self._off(p)
                    p += self.size_offsets + self.size_lengths
                    if level > 0:
                        walk_btree(child)
                    else:
                        walk_snod(child)

        def walk_snod(addr):
            assert b.d[addr:addr + 4] == b"SNOD", "bad SNOD"
            n = b.u(addr + 6, 2)
            p = addr + 8
            for _ in range(n):
                name_off = self._off(p)
                hdr = self._off(p + self.size_offsets)
                name = self._cstr(heap_data_addr + name_off)
                out.append((name, hdr))
                p += (2 * self.size_offsets + 4 + 4 + 16)

        walk_btree(btree_addr)
        return out

    def _parse_link(self, body):
        ver = body[0]
        flags = body[1]
        p = 2
        ltype = 0
        if flags & 0b1000:
            ltype = body[p]
            p += 1
        if flags & 0b100:
            p += 8  # creation order
        if flags & 0b10000:
            p += 1  # charset
        nlen_size = 1 << (flags & 0b11)
        nlen = int.from_bytes(body[p:p + nlen_size], "little")
        p += nlen_size
        name = body[p:p + nlen].decode("utf-8", "replace")
        p += nlen
        if ltype == 0:  # hard link
            addr = int.from_bytes(body[p:p + self.size_offsets], "little")
            return (name, addr)
        return None

    def _parse_link_info(self, body):
        """Fractal-heap-backed groups: not implemented; netCDF4 files
        use dense storage only beyond ~8 links with creation-order
        tracking — fall back to empty."""
        return []

    def _cstr(self, addr):
        b = self.buf.d
        end = b.index(b"\x00", addr)
        return b[addr:end].decode("utf-8", "replace")

    # --- dataset parsing ---
    def _parse_dataset(self, name, msgs) -> Optional[H5Dataset]:
        shape = ()
        maxshape = ()
        dtype = None
        layout = None
        filters: List[Tuple[int, List[int]]] = []
        fillvalue = None
        for mtype, body in msgs:
            if mtype == 0x01:    # dataspace
                shape = self._parse_dataspace(body)
            elif mtype == 0x03:  # datatype
                dtype = self._parse_datatype(body)
            elif mtype == 0x08:  # layout
                layout = self._parse_layout(body)
            elif mtype == 0x0B:  # filter pipeline
                filters = self._parse_filters(body)
            elif mtype == 0x05:  # fill value
                fillvalue = self._parse_fillvalue(body)
        if dtype is None or layout is None:
            return None
        attrs = self._parse_attrs(msgs)
        return H5Dataset(name=name, shape=shape, dtype=dtype, attrs=attrs,
                         _file=self, _layout=layout, _filters=filters,
                         _fillvalue=fillvalue)

    def _parse_dataspace(self, body):
        ver = body[0]
        rank = body[1]
        if ver == 1:
            p = 8
        else:
            p = 4
        dims = []
        for i in range(rank):
            dims.append(int.from_bytes(
                body[p + i * self.size_lengths:
                     p + (i + 1) * self.size_lengths], "little"))
        return tuple(dims)

    def _parse_datatype(self, body):
        cls = body[0] & 0x0F
        bits0 = body[1]
        size = int.from_bytes(body[4:8], "little")
        if cls == 0:    # fixed-point
            signed = bool(bits0 & 0b1000)
            return np.dtype(f"{'<' if not (bits0 & 1) else '>'}"
                            f"{'i' if signed else 'u'}{size}")
        if cls == 1:    # float
            return np.dtype(f"{'<' if not (bits0 & 1) else '>'}f{size}")
        if cls == 3:    # string
            return np.dtype(f"S{size}")
        raise NotImplementedError(f"datatype class {cls}")

    def _parse_layout(self, body):
        ver = body[0]
        if ver == 3:
            lclass = body[1]
            if lclass == 0:   # compact
                sz = int.from_bytes(body[2:4], "little")
                return ("compact", body[4:4 + sz])
            if lclass == 1:   # contiguous
                addr = int.from_bytes(body[2:2 + self.size_offsets],
                                      "little")
                size = int.from_bytes(
                    body[2 + self.size_offsets:
                         2 + self.size_offsets + self.size_lengths],
                    "little")
                return ("contiguous", addr, size)
            if lclass == 2:   # chunked
                rank = body[2]
                addr = int.from_bytes(body[3:3 + self.size_offsets],
                                      "little")
                p = 3 + self.size_offsets
                dims = [int.from_bytes(body[p + 4 * i:p + 4 * (i + 1)],
                                       "little") for i in range(rank)]
                # last dim is element size
                return ("chunked", addr, tuple(dims[:-1]))
        raise NotImplementedError(f"layout version {ver}")

    def _parse_filters(self, body):
        ver = body[0]
        nfilters = body[1]
        out = []
        if ver == 1:
            p = 8
        else:
            p = 2
        for _ in range(nfilters):
            fid = int.from_bytes(body[p:p + 2], "little")
            if ver == 1 or fid >= 256:
                nlen = int.from_bytes(body[p + 2:p + 4], "little")
                flags = int.from_bytes(body[p + 4:p + 6], "little")
                ncd = int.from_bytes(body[p + 6:p + 8], "little")
                p += 8
                p += (nlen + 7) // 8 * 8
            else:
                flags = int.from_bytes(body[p + 4:p + 6], "little")
                ncd = int.from_bytes(body[p + 6:p + 8], "little")
                p += 8
            cd = [int.from_bytes(body[p + 4 * i:p + 4 * (i + 1)], "little")
                  for i in range(ncd)]
            p += 4 * ncd
            if ver == 1 and ncd % 2 == 1:
                p += 4
            out.append((fid, cd))
        return out

    def _parse_fillvalue(self, body):
        ver = body[0]
        if ver in (1, 2):
            defined = body[3]
            if ver == 2 and not defined:
                return None
            sz = int.from_bytes(body[4:8], "little")
            return body[8:8 + sz]
        if ver == 3:
            flags = body[1]
            if flags & 0b100000:
                sz = int.from_bytes(body[2:6], "little")
                return body[6:6 + sz]
        return None

    def _parse_attrs(self, msgs) -> Dict[str, object]:
        out = {}
        for mtype, body in msgs:
            if mtype != 0x0C:
                continue
            try:
                name, val = self._parse_attr(body)
                out[name] = val
            except Exception:
                continue
        return out

    def _parse_attr(self, body):
        ver = body[0]
        if ver == 1:
            nlen = int.from_bytes(body[2:4], "little")
            dlen = int.from_bytes(body[4:6], "little")
            slen = int.from_bytes(body[6:8], "little")
            p = 8
            name = body[p:p + nlen].split(b"\x00")[0].decode()
            p += (nlen + 7) // 8 * 8
            dt_body = body[p:p + dlen]
            p += (dlen + 7) // 8 * 8
            ds_body = body[p:p + slen]
            p += (slen + 7) // 8 * 8
        elif ver in (2, 3):
            nlen = int.from_bytes(body[2:4], "little")
            dlen = int.from_bytes(body[4:6], "little")
            slen = int.from_bytes(body[6:8], "little")
            p = 8
            if ver == 3:
                p += 1  # name charset
            name = body[p:p + nlen].split(b"\x00")[0].decode()
            p += nlen
            dt_body = body[p:p + dlen]
            p += dlen
            ds_body = body[p:p + slen]
            p += slen
        else:
            raise NotImplementedError
        cls = dt_body[0] & 0x0F
        if cls == 9 or cls == 7:
            return name, None    # vlen/reference unsupported
        dtype = self._parse_datatype(dt_body)
        shape = self._parse_dataspace(ds_body) if ds_body else ()
        n = int(np.prod(shape)) if shape else 1
        raw = body[p:p + n * dtype.itemsize]
        vals = np.frombuffer(raw, dtype, count=n)
        if dtype.kind == "S":
            return name, vals[0].split(b"\x00")[0]
        if n == 1:
            return name, vals[0]
        return name, vals

    # --- chunk B-tree (v1) ---
    def _iter_chunks(self, addr, rank):
        b = self.buf
        if b.d[addr:addr + 4] != b"TREE":
            return
        level = b.u(addr + 5, 1)
        nentries = b.u(addr + 6, 2)
        key_size = 8 + 8 * (rank + 1)
        p = addr + 8 + 2 * self.size_offsets
        for _ in range(nentries):
            # key: chunk size (4), filter mask (4), offsets (8 each)
            size = b.u(p, 4)
            offsets = tuple(b.u(p + 8 + 8 * i, 8) for i in range(rank))
            p += key_size
            child = self._off(p)
            p += self.size_offsets
            if level > 0:
                yield from self._iter_chunks(child, rank)
            else:
                yield offsets, child, size


def open_netcdf_any(path: str):
    """Open a netCDF file of either flavor, returning a uniform
    (dimensions, variables) view.  Variables expose .shape and
    ``__getitem__`` plus attribute access like scipy's netcdf_file."""
    with open(path, "rb") as f:
        magic = f.read(8)
    if magic[:3] == b"CDF":
        from scipy.io import netcdf_file
        nc = netcdf_file(path, mmap=False)
        return nc.variables, nc
    if magic == _SIG:
        h5 = H5File(path)
        return {k: _H5VarShim(v) for k, v in h5.datasets.items()}, h5
    raise ValueError(f"Unrecognized netCDF format: {path}")


class _H5VarShim:
    """Make an H5Dataset quack like scipy's netcdf variable."""

    def __init__(self, ds: H5Dataset):
        self._ds = ds
        self.shape = ds.shape
        for k, v in ds.attrs.items():
            try:
                setattr(self, k, v)
            except Exception:
                pass

    def __getitem__(self, key):
        return self._ds.read()[key]
