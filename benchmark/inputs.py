"""The benchmark's inputs, made from its own code and the seed.

Frozen copies, owned by the benchmark so that a change to the program
cannot change the yardstick:

* ``wind_met``: the solid-body met of MPTRAC's ``wind`` tool (wind.c:
  62-180, the Williamson et al. 1992 rotated flow), as numpy arrays;
* ``write_met_nc``: the netCDF-3 met writer (MPTRAC ``write_met_nc``
  names and unit scalings);
* ``met_filename``: MPTRAC's ``<base>_YYYY_MM_DD_HH.nc`` file names;
* ``draw_parcels``: parcel positions drawn on the device from the seed.

Nothing here imports the program; ``harness`` hands these inputs to it.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Tuple

import numpy as np

#: constants of the met generator and the writer (MPTRAC mptrac.h)
P0 = 1013.25
H0 = 7.0
G0 = 9.80665
MA = 28.9644
MH2O = 18.01528
MO3 = 48.00

#: the met snapshot's field names (MPTRAC met_t)
MET_3D = ("z", "t", "u", "v", "w", "pv", "h2o", "o3", "lwc", "rwc", "iwc",
          "swc", "cc")
MET_2D = ("ps", "ts", "zs", "us", "vs", "ess", "nss", "shf", "lsm", "sst",
          "pbl", "pt", "tt", "zt", "h2ot", "pct", "pcb", "cl", "plcl",
          "plfc", "pel", "cape", "cin", "o3c")

_D2R = math.pi / 180.0


def wind_met(nx: int, ny: int, nz: int, alpha: float = 30.0,
             u0: float = 38.587660177302, temp0: float = 280.0,
             ps: float = 1013.25, zs: float = 0.0, blh: float = 1.0,
             z1: float = 60.0) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                        Dict[str, np.ndarray],
                                        Dict[str, np.ndarray]]:
    """(lon, lat, p, fields2d, fields3d) of one snapshot of the rotated
    solid-body flow on a global grid with ``nx`` + 1 longitudes (the
    wraparound column included), ``ny`` latitudes from -90 to 90 and
    ``nz`` levels equally spaced in log-pressure from the surface to
    ``z1`` km.  Fields are float32, computed in float64 and rounded
    once; the flow is steady (no field depends on the time).  The fields
    that MPTRAC's reader derives (CAPE and its levels, the cloud top,
    base and column water) hold what it derives for this dry met."""
    nxp = nx + 1
    lon = 360.0 / (nxp - 1) * np.arange(nxp)
    lat = 180.0 / (ny - 1) * np.arange(ny) - 90.0
    z = z1 * np.arange(nz) / (nz - 1.0)
    p = P0 * np.exp(-z / H0)
    clat = np.cos(_D2R * lat)[None, :, None]
    slat = np.sin(_D2R * lat)[None, :, None]
    clon = np.cos(_D2R * lon)[:, None, None]
    slon = np.sin(_D2R * lon)[:, None, None]
    ca, sa = math.cos(_D2R * alpha), math.sin(_D2R * alpha)
    uz = np.full(nz, u0)[None, None, :]
    u = np.broadcast_to(uz * (clat * ca + slat * clon * sa), (nxp, ny, nz))
    v = np.broadcast_to(-uz * slon * sa + 0.0 * clat, (nxp, ny, nz))
    shape3, shape2 = (nxp, ny, nz), (nxp, ny)
    f32 = np.float32
    f3 = {name: np.zeros(shape3, f32) for name in MET_3D}
    f3["u"] = np.ascontiguousarray(u, f32)
    f3["v"] = np.ascontiguousarray(v, f32)
    f3["t"] = np.full(shape3, temp0, f32)
    f3["z"] = np.ascontiguousarray(np.broadcast_to(z, shape3), f32)
    f2 = {name: np.zeros(shape2, f32) for name in MET_2D}
    f2["ps"] = np.full(shape2, ps, f32)
    f2["zs"] = np.full(shape2, zs, f32)
    f2["ts"] = np.full(shape2, temp0, f32)
    f2["us"] = np.ascontiguousarray(f3["u"][:, :, 0])
    f2["vs"] = np.ascontiguousarray(f3["v"][:, :, 0])
    f2["lsm"] = np.ones(shape2, f32)
    f2["sst"] = np.full(shape2, temp0, f32)
    f2["pbl"] = np.full(shape2, P0 * math.exp(-(zs + blh) / H0), f32)
    f2["pt"] = np.full(shape2, 200.0, f32)
    # what MPTRAC's reader derives for a dry, cloud-free column: no lifted
    # parcel (read_met_cape leaves every level NaN where the humidity is
    # 0) and no cloud top or base (read_met_cloud; the column water is 0)
    for name in ("plcl", "plfc", "pel", "cape", "cin", "pct", "pcb"):
        f2[name] = np.full(shape2, np.nan, f32)
    return lon, lat, p, f2, f3


#: (netCDF name, 2-D field, scale on write)
_SURF = (("sp", "ps", 100.0), ("z", "zs", 1000.0 * G0), ("t2m", "ts", 1.0),
         ("u10m", "us", 1.0), ("v10m", "vs", 1.0), ("iews", "ess", 1.0),
         ("inss", "nss", 1.0), ("ishf", "shf", 1.0), ("lsm", "lsm", 1.0),
         ("sstk", "sst", 1.0), ("blp", "pbl", 100.0), ("pt", "pt", 100.0),
         ("tt", "tt", 1.0), ("zt", "zt", 1000.0), ("h2ot", "h2ot", 1.0),
         ("pct", "pct", 100.0), ("pcb", "pcb", 100.0), ("cl", "cl", 1.0),
         ("plcl", "plcl", 100.0), ("plfc", "plfc", 100.0),
         ("pel", "pel", 100.0), ("cape", "cape", 1.0), ("cin", "cin", 1.0),
         ("o3c", "o3c", 1.0))

#: (netCDF name, 3-D field, scale on write; None: vmr to mass ratio)
_LEV = (("t", "t", 1.0), ("u", "u", 1.0), ("v", "v", 1.0),
        ("w", "w", 100.0), ("q", "h2o", None), ("o3", "o3", None),
        ("clwc", "lwc", 1.0), ("crwc", "rwc", 1.0), ("ciwc", "iwc", 1.0),
        ("cswc", "swc", 1.0), ("cc", "cc", 1.0))


def write_met_nc(path: str, t: float, lon, lat, p, f2, f3) -> None:
    """One snapshot as a netCDF-3 file with MPTRAC's variable names and
    units (surface pressure in Pa, omega in Pa/s, humidity as specific
    humidity); the wraparound longitude column is dropped."""
    from scipy.io import netcdf_file

    nx = lon.size - 1
    ny, npl = lat.size, p.size
    nc = netcdf_file(path, "w")
    try:
        nc.createDimension("time", 1)
        nc.createDimension("lon", nx)
        nc.createDimension("lat", ny)
        nc.createDimension("lev", npl)
        vt = nc.createVariable("time", "d", ("time",))
        vt[:] = np.asarray([float(t)])
        vt.units = b"seconds since 2000-01-01 00:00:00 UTC"
        nc.createVariable("lon", "d", ("lon",))[:] = lon[:nx]
        nc.createVariable("lat", "d", ("lat",))[:] = lat
        vl = nc.createVariable("lev", "d", ("lev",))
        vl[:] = p * 100.0
        vl.units = b"Pa"
        for name, field, scale in _SURF:
            v = nc.createVariable(name, "f", ("time", "lat", "lon"))
            v[:] = (f2[field][:nx].T[None] * scale).astype(np.float32)
        for name, field, scale in _LEV:
            v = nc.createVariable(name, "f", ("time", "lev", "lat", "lon"))
            if scale is None:
                scale = (MH2O / MA) if name == "q" else (MO3 / MA)
            v[:] = (f3[field][:nx].transpose(2, 1, 0)[None]
                    * scale).astype(np.float32)
    finally:
        nc.close()


def met_filename(base: str, t: float) -> str:
    """MPTRAC's met file name of time ``t`` [s since 2000-01-01, a whole
    hour]: ``<base>_YYYY_MM_DD_HH.nc``."""
    import datetime
    when = (datetime.datetime(2000, 1, 1)
            + datetime.timedelta(seconds=float(t)))
    return f"{base}_{when:%Y_%m_%d_%H}.nc"


def met_series(directory: str, grid: dict, met: dict, dt_met: float,
               nfiles: int) -> str:
    """Write (once) the hourly series of ``nfiles`` met files from time 0
    into ``directory``; returns the files' base name.  A file
    ``complete`` written last marks a finished series, so a run cut off
    while writing starts the series again."""
    base = os.path.join(directory, "met")
    done = os.path.join(directory, "complete")
    want = f"{nfiles} {dt_met} {sorted(grid.items())} {sorted(met.items())}"
    if os.path.exists(done):
        with open(done) as f:
            if f.read() == want:
                return base
    os.makedirs(directory, exist_ok=True)
    if os.path.exists(done):
        os.remove(done)
    arrays = wind_met(grid["nx"], grid["ny"], grid["nz"], **met)
    for k in range(nfiles):
        write_met_nc(met_filename(base, k * dt_met), k * dt_met, *arrays)
    with open(done, "w") as f:
        f.write(want)
    return base


def draw_parcels(n: int, seed: int, box: dict, device):
    """(lon, lat, p) float32 tensors of ``n`` parcels uniform in the
    ``box`` ranges, drawn on ``device`` from ``seed`` in three calls."""
    import torch
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    out = []
    for key in ("lon", "lat", "p"):
        lo, hi = box[key]
        x = torch.rand(n, generator=gen, device=device, dtype=torch.float32)
        out.append(x.mul_(hi - lo).add_(lo))
    return tuple(out)


def draw_slots(n: int, count: int, seed: int, salt: int) -> np.ndarray:
    """``count`` distinct parcel slots of ``n``, sorted, from the seed."""
    rng = np.random.default_rng([int(seed) & (2 ** 63 - 1), salt])
    count = min(count, n)
    slots = np.unique(rng.integers(0, n, size=count + count // 4 + 16))
    while slots.size < count:
        slots = np.unique(np.concatenate(
            [slots, rng.integers(0, n, size=count)]))
    return np.sort(rng.permutation(slots)[:count])
