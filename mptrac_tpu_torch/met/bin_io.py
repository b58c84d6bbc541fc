"""MPTRAC binary met container (version 104).

Counterpart of the JAX package's ``met/bin_io.py``, with the same file
format.  Reference: read_met_bin (mptrac.c:8563-8862), write_met_bin
(c:13670-13922), compress_pck (c:986-1261, per-level 16-bit
scale/offset quantization with optional outer ZSTD), compress_zstd
(c:1624-1740).

Codecs by ``MET_TYPE``: 1 raw float, 2 PCK (+ ``MET_PCK_ZSTD`` outer
zstd), 4 ZSTD of the raw float stream, 8 LZ4 raw blocks (``met/lz4``,
the native codec), and the lossy 3 (ZFP-style), 5 (CMS-style) and 7
(SZ3-style) of ``met/lossy``; ZSTD through the system's libzstd
(``met/zstd``).  3-D payloads are laid out [ixy, iz]
(level-fastest), as the reference's ARRAY layout.

``read_met_bin`` keeps the byte stages on the host (the file read,
zstd, lz4) and runs the numeric stage as torch on the device the
``Met`` goes to: PCK's ``s * scl + off`` in float64, the lossy decoders,
the clamp of every 3-D field to ``BIN_3D``'s bounds and the cast to
float32.  What crosses to the device is the stream as stored (2 B a
value for PCK, the narrow integers of the lossy codecs).  The writer
stays host numpy, the JAX package's arithmetic: its files are the JAX
writer's byte for byte, but for the ZSTD frames, whose compressed bytes
depend on the zstd release (they decode to the same bytes).
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional

import numpy as np
import torch

from mptrac_tpu_torch.types import MET_2D_FIELDS, MET_3D_FIELDS, Met
from mptrac_tpu_torch.utils import timers

PCK_ZSTD_MAGIC = 0x50434B5A53544431

#: 2-D field write order (reference c:8666-8689)
BIN_2D = ("ps", "ts", "zs", "us", "vs", "ess", "nss", "shf", "lsm",
          "sst", "pbl", "pt", "tt", "zt", "h2ot", "pct", "pcb", "cl",
          "plcl", "plfc", "pel", "cape", "cin", "o3c")
#: 3-D field write order with clamping bounds (reference c:8692-8706)
BIN_3D = (("z", -1e34, 1e34), ("t", 0, 1e34), ("u", -1e34, 1e34),
          ("v", -1e34, 1e34), ("w", -1e34, 1e34), ("pv", -1e34, 1e34),
          ("h2o", 0, 1e34), ("o3", 0, 1e34), ("lwc", 0, 1e34),
          ("rwc", 0, 1e34), ("iwc", 0, 1e34), ("swc", 0, 1e34),
          ("cc", 0, 1))

#: the container types this module reads and writes
BIN_TYPES = (1, 2, 3, 4, 5, 7, 8)
_CODEC = {2: "PCK", 3: "ZFP", 4: "ZSTD", 5: "CMS", 7: "SQZ", 8: "LZ4"}

#: the stages of a read whose seconds ``read_stages`` adds up
STAGES = ("read", "decode_host", "upload", "decode_device")


def read_stages(timings: Optional[Dict[str, float]], dev):
    """The stages of one read: ``with stages("read"): ...``, where
    ``stages = read_stages(timings, dev)``, is the span
    ``read`` (``utils.timers.stage``), whose host seconds are added to
    ``timings[name]`` (a dict, when given).  ``upload`` and
    ``decode_device`` synchronize a CUDA device at their end when
    ``timings`` is given, so that their time is their own."""
    return lambda name: timers.stage(
        name, timings,
        sync=dev if name in ("upload", "decode_device") else None)


def _log_codec(name: str, codec: str, n_values: int, comp_len: int,
               verbose: bool, stats: Optional[List] = None) -> None:
    """Compression diagnostics (reference COMPRESS_RATIO/BPV logging,
    mptrac.h:561-585): ratio vs float32 payload and bits per value.
    ``stats``, when given, gets (name, codec, n_values, comp_len)."""
    if stats is not None:
        stats.append((name, codec, n_values, comp_len))
    if verbose:
        raw = 4 * n_values
        print(f"Write 3-D variable: {name} ({codec}, "
              f"RATIO={raw / max(comp_len, 1):g}, "
              f"BPV={8 * comp_len / max(n_values, 1):g})")


def _pck_compress(arr: np.ndarray, use_zstd: bool, level: int = -3
                  ) -> bytes:
    """arr: [nxy, nz] float32 -> PCK payload."""
    vmin = arr.min(axis=0).astype(np.float64)
    vmax = arr.max(axis=0).astype(np.float64)
    scl = (vmax - vmin) / 65533.0
    off = vmin
    with np.errstate(divide="ignore", invalid="ignore"):
        s = np.where(scl != 0,
                     ((arr - off) / np.where(scl != 0, scl, 1)
                      + 0.5).astype(np.uint16), 0)
    payload = scl.tobytes() + off.tobytes() + s.astype("<u2").tobytes()
    if use_zstd:
        from mptrac_tpu_torch.met import zstd
        comp = zstd.compress(payload, level)
        return (struct.pack("<Q", PCK_ZSTD_MAGIC)
                + struct.pack("<Q", len(comp)) + comp)
    return payload


def _pck_decompress(f, nxy: int, nz: int, use_zstd: bool, dev,
                    stages) -> torch.Tensor:
    """PCK payload -> [nxy, nz] float32 on ``dev``: the samples cross as
    16-bit integers, widened to int32 and scaled in float64 there."""
    with stages("read"):
        if use_zstd:
            magic, = struct.unpack("<Q", f.read(8))
            if magic != PCK_ZSTD_MAGIC:
                raise ValueError("PCK+ZSTD magic mismatch!")
            stored_len, = struct.unpack("<Q", f.read(8))
            payload = f.read(stored_len)
        else:
            payload = f.read(16 * nz + 2 * nxy * nz)
    if use_zstd:
        from mptrac_tpu_torch.met import zstd
        with stages("decode_host"):
            payload = zstd.decompress(payload, 16 * nz + 2 * nxy * nz + 64)
    from mptrac_tpu_torch.met.lossy import upload
    with stages("upload"):
        scl = upload(payload[:8 * nz], "<f8", dev)
        off = upload(payload[8 * nz:16 * nz], "<f8", dev)
        s = upload(payload[16 * nz:16 * nz + 2 * nxy * nz], "<i2", dev)
    with stages("decode_device"):
        s = (s.to(torch.int32) & 0xFFFF).reshape(nxy, nz)
        return (s.to(torch.float64) * scl + off).to(torch.float32)


def clamp3(name: str, field: torch.Tensor) -> torch.Tensor:
    """A 3-D field clamped to its ``BIN_3D`` bounds (np.clip's result:
    NaN stays NaN)."""
    for n, lo, hi in BIN_3D:
        if n == name:
            return field.clamp(lo, hi)
    raise KeyError(name)


def finish_raw(raw: Dict[str, object], dev,
               stages) -> Dict[str, object]:
    """The raw dict of a container read with its fields on ``dev``:
    host arrays uploaded (the native loader's route), every ``BIN_3D``
    field clamped, the fields that the container does not hold filled as
    the JAX reader fills them (2-D NaN, 3-D zeros)."""
    with stages("upload"):
        f2, f3 = ({k: torch.as_tensor(v, device=dev)
                   for k, v in raw[kind].items()}
                  for kind in ("fields2d", "fields3d"))
    with stages("decode_device"):
        f3 = {k: clamp3(k, v) for k, v in f3.items()}
        nx, ny, npl = len(raw["lon"]), len(raw["lat"]), len(raw["p"])
        for name in MET_2D_FIELDS:
            if name not in f2:
                f2[name] = torch.full((nx, ny), float("nan"),
                                      dtype=torch.float32, device=dev)
        for name in MET_3D_FIELDS:
            if name not in f3:
                f3[name] = torch.zeros((nx, ny, npl), dtype=torch.float32,
                                       device=dev)
    return dict(raw, fields2d=f2, fields3d=f3)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def write_met_bin(filename: str, met: Met, met_type: int = 1,
                  pck_zstd: bool = False, zstd_level: int = -3,
                  verbose: bool = False, ctl=None,
                  stats: Optional[List] = None) -> None:
    """Write one snapshot (host numpy, the JAX writer's bytes).  ``ctl``
    supplies the per-variable lossy codec settings for met_type 3/5/7
    (defaults used when omitted); ``stats`` collects each 3-D field's
    (name, codec, values, stored bytes)."""
    ctl_codec = ctl
    if ctl_codec is None and met_type in (3, 5, 7):
        from mptrac_tpu_torch.config import read_ctl
        ctl_codec = read_ctl(None, ["MET_TYPE", str(met_type),
                                    "METBASE", "-"])
    if met_type not in BIN_TYPES:
        raise NotImplementedError(f"MET_TYPE {met_type}")
    nx, ny, npl = met.nx, met.ny, met.npl
    with open(filename, "wb") as f:
        f.write(struct.pack("<ii", met_type, 104))
        f.write(struct.pack("<d", float(met.time)))
        f.write(struct.pack("<iii", nx, ny, npl))
        _np(met.lon).astype("<f8").tofile(f)
        _np(met.lat).astype("<f8").tofile(f)
        _np(met.p).astype("<f8").tofile(f)
        for name in BIN_2D:
            _np(met.fields2d[name]).astype("<f4").tofile(f)
        for name, lo, hi in BIN_3D:
            arr = np.clip(_np(met.fields3d[name]).astype(np.float32),
                          lo, hi)
            flat = arr.reshape(nx * ny, npl)
            if met_type == 1:
                flat.astype("<f4").tofile(f)
                continue
            if met_type == 2:
                payload = _pck_compress(flat, pck_zstd, zstd_level)
            elif met_type in (4, 8):
                data = flat.astype("<f4").tobytes()
                if met_type == 4:
                    from mptrac_tpu_torch.met import zstd
                    comp = zstd.compress(data, zstd_level)
                else:
                    from mptrac_tpu_torch.met import lz4
                    comp = lz4.compress(data)
                payload = struct.pack("<Q", len(comp)) + comp
            else:
                from mptrac_tpu_torch.met import lossy
                encode = {7: lossy.sqz_compress, 5: lossy.cms_compress,
                          3: lossy.zfp_compress}[met_type]
                payload = encode(ctl_codec, name, flat, nx, ny)
            # (the JAX writer logs the zstd and lz4 block without its
            # 8-byte length)
            _log_codec(name, _CODEC[met_type], flat.size,
                       len(payload) - 8 * (met_type in (4, 8)), verbose,
                       stats)
            f.write(payload)
        f.write(struct.pack("<i", 999))


def read_met_bin(filename: str, ctl, device="cuda",
                 timings: Optional[Dict[str, float]] = None
                 ) -> Dict[str, object]:
    """Read into the raw dict form that ``met.build`` consumes, with the
    fields as float32 tensors on ``device`` ([nx, ny] and [nx, ny, npl])
    and the axes as host float64 arrays.  ``timings``, when given, gets
    the seconds of each of ``STAGES`` added."""
    from mptrac_tpu_torch.met import lossy
    from mptrac_tpu_torch.types import resolve_device
    dev = resolve_device(device)
    stages = read_stages(timings, dev)
    met_type = ctl.met_type
    if met_type not in BIN_TYPES:
        raise NotImplementedError(f"MET_TYPE {met_type}")
    with open(filename, "rb") as f:
        with stages("read"):
            ftype, version = struct.unpack("<ii", f.read(8))
            if ftype != met_type:
                raise ValueError("Wrong MET_TYPE of binary data!")
            if version != 104:
                raise ValueError("Wrong version of binary data!")
            time, = struct.unpack("<d", f.read(8))
            nx, ny, npl = struct.unpack("<iii", f.read(12))
            lon = np.fromfile(f, "<f8", nx)
            lat = np.fromfile(f, "<f8", ny)
            p = np.fromfile(f, "<f8", npl)
            f2h = {name: np.fromfile(f, "<f4", nx * ny).reshape(nx, ny)
                   for name in BIN_2D}
        with stages("upload"):
            f2 = {k: torch.from_numpy(v).to(dev) for k, v in f2h.items()}
        del f2h
        n3 = nx * ny * npl
        f3 = {}
        for name, _, _ in BIN_3D:
            if met_type == 2:
                flat = _pck_decompress(f, nx * ny, npl,
                                       bool(ctl.met_pck_zstd), dev, stages)
            elif met_type in (1, 4, 8):
                with stages("read"):
                    if met_type == 1:
                        host = np.fromfile(f, "<f4", n3)
                    else:
                        clen, = struct.unpack("<Q", f.read(8))
                        comp = f.read(clen)
                if met_type == 4:
                    from mptrac_tpu_torch.met import zstd
                    with stages("decode_host"):
                        host = zstd.decompress(comp, 4 * n3).view("<f4")
                elif met_type == 8:
                    from mptrac_tpu_torch.met import lz4
                    with stages("decode_host"):
                        host = lz4.decompress(comp, 4 * n3).view("<f4")
                with stages("upload"):
                    flat = torch.from_numpy(host).to(dev)
            else:
                decode = {7: lossy.sqz_decompress, 5: lossy.cms_decompress,
                          3: lossy.zfp_decompress}[met_type]
                flat = decode(f, nx, ny, npl, dev, stages)
            f3[name] = flat.reshape(nx, ny, npl)
        with stages("read"):
            final, = struct.unpack("<i", f.read(4))
            if final != 999:
                raise ValueError("Error while reading binary data!")
    raw = dict(time=time, lon=lon, lat=lat, p=p, hybrid=np.zeros(npl),
               fields2d=f2, fields3d=f3, coord_type=ctl.met_coord_type,
               npl_ml=0)
    return finish_raw(raw, dev, stages)
