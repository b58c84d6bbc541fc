"""Pure-Python GRIB edition 1 decoder.

Counterpart of the JAX package's ``io/grib1.py``.  The reference reads
GRIB via ecCodes (optional ECCODES=1 build, read_met_grib mptrac.c:10467);
without a grib library the container is decoded directly: IS/PDS/GDS/BMS/
BDS sections, simple packing (reference value + binary/decimal scaling +
fixed bit width), regular lat/lon grids.  Decoding is bit unpacking of a
byte stream and stays on the host with numpy.

Returns records with ECMWF table-2 parameter codes (the same ``code``
numbers the netCDF files carry: t=130, u=131, v=132, w=135, q=133,
lnsp/sp=152/134, z=129, o3=203, clwc/ciwc/crwc/cswc=246/247/75/76,
cc=248, and surface fields).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import List, Optional

import numpy as np


@dataclass
class GribRecord:
    param: int
    table: int
    level_type: int
    level: int
    year: int
    mon: int
    day: int
    hour: int
    minute: int
    nx: int
    ny: int
    lon0: float
    lon1: float
    dlon: float
    lat0: float
    lat1: float
    values: np.ndarray       # [ny, nx], row 0 = lat0 (scan order)


def _u(b, i, n):
    return int.from_bytes(b[i:i + n], "big")


def _s3(b, i):
    """GRIB sign-magnitude 3-byte integer."""
    v = _u(b, i, 3)
    if v & 0x800000:
        return -(v & 0x7FFFFF)
    return v


def _s2(b, i):
    v = _u(b, i, 2)
    if v & 0x8000:
        return -(v & 0x7FFF)
    return v


def _ibm_float(b, i):
    """IBM 370 single-precision float (GRIB1 reference values)."""
    a = b[i]
    sign = -1.0 if a & 0x80 else 1.0
    exp = (a & 0x7F) - 64
    mant = _u(b, i + 1, 3)
    return sign * mant * 16.0 ** (exp - 6)


def decode_file(path: str) -> List[GribRecord]:
    data = open(path, "rb").read()
    out = []
    pos = 0
    while True:
        idx = data.find(b"GRIB", pos)
        if idx < 0:
            break
        edition = data[idx + 7]
        if edition == 2:
            from mptrac_tpu_torch.io import grib2
            total = struct.unpack(">Q", data[idx + 8:idx + 16])[0]
            rec = grib2.decode_message(data[idx:idx + total])
            if rec is not None:
                out.append(rec)
            pos = idx + total
            continue
        if edition != 1:
            raise NotImplementedError(f"GRIB edition {edition}")
        total = _u(data, idx + 4, 3)
        rec = _decode_message(data[idx:idx + total])
        if rec is not None:
            out.append(rec)
        pos = idx + total
    return out


def _decode_message(msg: bytes) -> Optional[GribRecord]:
    p = 8  # after IS
    # --- PDS ---
    pds_len = _u(msg, p, 3)
    pds = msg[p:p + pds_len]
    table = pds[3]
    has_gds = bool(pds[7] & 0x80)
    has_bms = bool(pds[7] & 0x40)
    param = pds[8]
    level_type = pds[9]
    level = _u(pds, 10, 2)
    year = pds[12]
    mon = pds[13]
    day = pds[14]
    hour = pds[15]
    minute = pds[16]
    century = pds[24] if pds_len > 24 else 21
    year_full = (century - 1) * 100 + year
    d_scale = _s2(pds, 26) if pds_len > 27 else 0
    p += pds_len

    # --- GDS ---
    if not has_gds:
        return None
    gds_len = _u(msg, p, 3)
    gds = msg[p:p + gds_len]
    rep = gds[5]
    if rep != 0:  # only regular lat/lon
        return None
    nx = _u(gds, 6, 2)
    ny = _u(gds, 8, 2)
    lat0 = _s3(gds, 10) / 1000.0
    lon0 = _s3(gds, 13) / 1000.0
    lat1 = _s3(gds, 17) / 1000.0
    lon1 = _s3(gds, 20) / 1000.0
    dlon = _s2(gds, 23) / 1000.0
    scan = gds[27]
    p += gds_len

    # --- BMS ---
    bitmap = None
    if has_bms:
        bms_len = _u(msg, p, 3)
        unused = msg[p + 3]
        bm_bytes = msg[p + 6:p + bms_len]
        bits = np.unpackbits(np.frombuffer(bm_bytes, np.uint8))
        bitmap = bits[:nx * ny].astype(bool)
        p += bms_len

    # --- BDS ---
    bds_len = _u(msg, p, 3)
    bds = msg[p:p + bds_len]
    flags = bds[3]
    if flags & 0xC0:  # spherical harmonics / complex packing
        raise NotImplementedError("GRIB1 non-simple packing")
    e_scale = _s2(bds, 4)
    ref = _ibm_float(bds, 6)
    nbits = bds[10]
    unused_bits = flags & 0x0F
    npts = int(bitmap.sum()) if bitmap is not None else nx * ny
    if nbits == 0:
        vals = np.full(npts, ref)
    else:
        raw = np.unpackbits(np.frombuffer(bds[11:], np.uint8))
        nvals = (len(raw) - unused_bits) // nbits
        nvals = min(nvals, npts)
        ints = raw[:nvals * nbits].reshape(nvals, nbits)
        weights = (1 << np.arange(nbits - 1, -1, -1)).astype(np.int64)
        x = ints.astype(np.int64) @ weights
        vals = (ref + x * 2.0 ** e_scale) / 10.0 ** d_scale
    full = np.full(nx * ny, np.nan)
    if bitmap is not None:
        full[bitmap] = vals
    else:
        full[:len(vals)] = vals
    grid = full.reshape(ny, nx)
    if scan & 0x40:  # +j scan (south to north): normalize row order
        pass         # keep native order; lat0/lat1 describe it
    return GribRecord(param=param, table=table, level_type=level_type,
                      level=level, year=year_full, mon=mon, day=day,
                      hour=hour, minute=minute, nx=nx, ny=ny,
                      lon0=lon0, lon1=lon1, dlon=dlon, lat0=lat0,
                      lat1=lat1, values=grid)
