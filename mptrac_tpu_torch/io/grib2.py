"""Pure-Python GRIB edition 2 decoder (+ minimal encoder).

Counterpart of the JAX package's ``io/grib2.py``.  The reference reads
GRIB through ecCodes (read_met_grib, mptrac.c:10467-10907), which handles
editions 1 and 2 transparently; here edition 2 is decoded directly on
the host: sections 0-8, grid definition template 3.0 (regular lat/lon),
product definition templates 4.0/4.8, data representation template 5.0
(simple packing) with optional section-6 bitmap.

Records are normalized to the same :class:`mptrac_tpu_torch.io.grib1.
GribRecord` shape with ECMWF table-2 parameter codes, so the met ingest
layer (met.read_grib) is edition-agnostic.

A minimal encoder (``encode_message``) writes template 3.0/5.0 messages:
enough to generate test fixtures and export met fields (the reference
has no GRIB writer).
"""

from __future__ import annotations

import struct
from typing import List, Optional

import numpy as np

from mptrac_tpu_torch.io.grib1 import GribRecord

#: (discipline, category, number) -> ECMWF table-2 code
#: (the code numbers the met ingest and netCDF alias tables use)
PARAM_TO_CODE = {
    (0, 0, 0): 130,     # temperature
    (0, 2, 2): 131,     # u wind
    (0, 2, 3): 132,     # v wind
    (0, 2, 8): 135,     # omega [Pa/s]
    (0, 1, 0): 133,     # specific humidity
    (0, 3, 4): 129,     # geopotential
    (0, 3, 0): 134,     # surface pressure
    (0, 3, 25): 152,    # log surface pressure
    (0, 14, 1): 203,    # ozone mass mixing ratio
    (0, 1, 83): 246,    # cloud liquid water content
    (0, 1, 84): 247,    # cloud ice water content
    (0, 1, 85): 75,     # rain water content
    (0, 1, 86): 76,     # snow water content
    (0, 6, 22): 248,    # cloud cover fraction
    (0, 6, 32): 248,    # fraction of cloud cover (alt encoding)
    (0, 0, 17): 235,    # skin temperature
    (2, 0, 0): 172,     # land-sea mask
    (0, 2, 22): 180,    # eastward surface stress (alt)
    (10, 3, 0): 34,     # sea surface temperature
    (0, 3, 18): 159,    # boundary layer height
    (0, 7, 6): 59,      # CAPE
    (0, 0, 2): 167,     # 2m temperature (local use)
    (0, 2, 38): 165,    # 10m u (approx)
    (0, 2, 39): 166,    # 10m v (approx)
}

#: inverse map for the encoder
CODE_TO_PARAM = {}
for _k, _v in PARAM_TO_CODE.items():
    CODE_TO_PARAM.setdefault(_v, _k)


def _u(b, i, n):
    return int.from_bytes(b[i:i + n], "big")


def _sgm(b, i, n):
    """GRIB sign-magnitude integer over n bytes."""
    v = _u(b, i, n)
    top = 1 << (8 * n - 1)
    if v & top:
        return -(v & (top - 1))
    return v


def decode_message(msg: bytes) -> Optional[GribRecord]:
    """One edition-2 message (starting at 'GRIB')."""
    discipline = msg[6]
    p = 16
    year = mon = day = hour = minute = 0
    nx = ny = 0
    lon0 = lon1 = dlon = lat0 = lat1 = 0.0
    pcat = pnum = -1
    level_type = 255
    level = 0
    ref = 0.0
    e_scale = d_scale = 0
    nbits = 0
    bitmap = None
    values = None
    scan = 0

    while p < len(msg) - 4:
        if msg[p:p + 4] == b"7777":
            break
        slen = _u(msg, p, 4)
        snum = msg[p + 4]
        sec = msg[p:p + slen]
        if snum == 1:
            year = _u(sec, 12, 2)
            mon, day, hour, minute = sec[14], sec[15], sec[16], sec[17]
        elif snum == 3:
            tmpl = _u(sec, 12, 2)
            if tmpl != 0:
                return None          # only regular lat/lon
            nx = _u(sec, 30, 4)
            ny = _u(sec, 34, 4)
            lat0 = _sgm(sec, 46, 4) / 1e6
            lon0 = _sgm(sec, 50, 4) / 1e6
            lat1 = _sgm(sec, 55, 4) / 1e6
            lon1 = _sgm(sec, 59, 4) / 1e6
            dlon = _sgm(sec, 63, 4) / 1e6
            scan = sec[71]
        elif snum == 4:
            tmpl = _u(sec, 7, 2)
            if tmpl in (0, 1, 8, 11):
                pcat = sec[9]
                pnum = sec[10]
                level_type = sec[22]
                sfac = sec[23]
                sval = _u(sec, 24, 4)
                level = sval / 10.0 ** sfac if sfac not in (0, 255) \
                    else sval
        elif snum == 5:
            tmpl = _u(sec, 9, 2)
            if tmpl != 0:
                raise NotImplementedError(
                    f"GRIB2 data representation template {tmpl}")
            ref = struct.unpack(">f", sec[11:15])[0]
            e_scale = _sgm(sec, 15, 2)
            d_scale = _sgm(sec, 17, 2)
            nbits = sec[19]
        elif snum == 6:
            ind = sec[5]
            if ind == 0:
                bits = np.unpackbits(
                    np.frombuffer(sec[6:], np.uint8))
                bitmap = bits[:nx * ny].astype(bool)
            elif ind != 255:
                raise NotImplementedError(
                    f"GRIB2 bitmap indicator {ind}")
        elif snum == 7:
            npts = int(bitmap.sum()) if bitmap is not None else nx * ny
            if nbits == 0:
                vals = np.full(npts, ref * 10.0 ** -d_scale)
            else:
                raw = np.unpackbits(np.frombuffer(sec[5:], np.uint8))
                nvals = min(len(raw) // nbits, npts)
                ints = raw[:nvals * nbits].reshape(nvals, nbits)
                weights = (1 << np.arange(nbits - 1, -1, -1)).astype(
                    np.int64)
                x = ints.astype(np.int64) @ weights
                vals = (ref + x * 2.0 ** e_scale) / 10.0 ** d_scale
            full = np.full(nx * ny, np.nan)
            if bitmap is not None:
                full[bitmap] = vals
            else:
                full[:len(vals)] = vals
            values = full.reshape(ny, nx)
        p += slen

    if values is None or nx == 0:
        return None
    if level_type == 100:
        level = level / 100.0      # GRIB2 Pa -> GRIB1-convention hPa
    code = PARAM_TO_CODE.get((discipline, pcat, pnum), -1)
    return GribRecord(param=code, table=128, level_type=level_type,
                      level=int(level), year=year, mon=mon, day=day,
                      hour=hour, minute=minute, nx=nx, ny=ny,
                      lon0=lon0, lon1=lon1, dlon=dlon, lat0=lat0,
                      lat1=lat1, values=values)


def encode_message(code: int, level: int, values: np.ndarray,
                   lon, lat, when=(2000, 1, 1, 0, 0),
                   level_type: int = 105, nbits: int = 16) -> bytes:
    """Minimal GRIB2 message: templates 3.0 + 4.0 + 5.0 (simple
    packing).  ``values`` [ny, nx]; lon/lat 1-D axes matching it."""
    disc, pcat, pnum = CODE_TO_PARAM[code]
    if level_type == 100:
        level = int(round(level * 100))   # hPa -> Pa on the wire
    ny, nx = values.shape
    v = np.asarray(values, np.float64).reshape(-1)
    vmin, vmax = float(v.min()), float(v.max())
    if vmax > vmin:
        e = int(np.ceil(np.log2((vmax - vmin)
                                / (2 ** nbits - 1)))) if nbits else 0
        x = np.round((v - vmin) / 2.0 ** e).astype(np.int64)
    else:
        e = 0
        nbits = 0
        x = np.zeros(0, np.int64)

    def sgm(val, n):
        if val < 0:
            val = (1 << (8 * n - 1)) | (-val)
        return int(val).to_bytes(n, "big")

    sec1 = (struct.pack(">IB", 21, 1) + b"\x00\x62\x00\x00\x01\x00\x01"
            + struct.pack(">H", when[0])
            + bytes([when[1], when[2], when[3], when[4], 0, 0, 1]))
    # grid definition template 3.0
    g = bytearray(struct.pack(">IB", 72, 3))
    g += b"\x00" + struct.pack(">I", nx * ny) + b"\x00\x00"
    g += struct.pack(">H", 0)                    # template 3.0
    g += bytes([6]) + b"\x00" * 15               # sphere + radii
    g += struct.pack(">I", nx) + struct.pack(">I", ny)
    g += struct.pack(">I", 0) + b"\xff\xff\xff\xff"
    g += sgm(round(float(lat[0]) * 1e6), 4)
    g += sgm(round(float(lon[0]) * 1e6), 4)
    g += bytes([48])
    g += sgm(round(float(lat[-1]) * 1e6), 4)
    g += sgm(round(float(lon[-1]) * 1e6), 4)
    dlon = (float(lon[-1]) - float(lon[0])) / max(nx - 1, 1)
    dlat = (float(lat[-1]) - float(lat[0])) / max(ny - 1, 1)
    g += sgm(round(dlon * 1e6), 4)
    g += sgm(round(abs(dlat) * 1e6), 4)
    g += bytes([0x40 if dlat > 0 else 0x00])
    assert len(g) == 72, len(g)
    # product definition template 4.0
    s4 = bytearray(struct.pack(">IB", 34, 4))
    s4 += struct.pack(">H", 0) + struct.pack(">H", 0)
    s4 += bytes([pcat, pnum, 0, 0, 0xFF, 0, 0])
    s4 += struct.pack(">I", 0)
    s4 += bytes([0, 0])
    s4 += bytes([level_type, 0]) + struct.pack(">I", level)
    s4 += bytes([255, 255]) + b"\xff\xff\xff\xff"
    assert len(s4) == 34, len(s4)
    # data representation template 5.0
    s5 = (struct.pack(">IB", 21, 5) + struct.pack(">I", nx * ny)
          + struct.pack(">H", 0) + struct.pack(">f", vmin)
          + sgm(e, 2) + sgm(0, 2) + bytes([nbits, 0]))
    s6 = struct.pack(">IB", 6, 6) + bytes([255])
    if nbits:
        bits = ((x[:, None] >> np.arange(nbits - 1, -1, -1)) & 1
                ).astype(np.uint8)
        payload = np.packbits(bits.reshape(-1)).tobytes()
    else:
        payload = b""
    s7 = struct.pack(">IB", 5 + len(payload), 7) + payload

    body = sec1 + bytes(g) + bytes(s4) + s5 + s6 + s7
    total = 16 + len(body) + 4
    sec0 = (b"GRIB" + b"\x00\x00" + bytes([disc, 2])
            + struct.pack(">Q", total))
    return sec0 + body + b"7777"


def decode_file(path: str) -> List[GribRecord]:
    """All edition-2 messages in a file."""
    data = open(path, "rb").read()
    out = []
    pos = 0
    while True:
        idx = data.find(b"GRIB", pos)
        if idx < 0:
            break
        total = struct.unpack(">Q", data[idx + 8:idx + 16])[0]
        rec = decode_message(data[idx:idx + total])
        if rec is not None:
            out.append(rec)
        pos = idx + total
    return out
