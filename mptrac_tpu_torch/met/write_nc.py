"""netCDF met writer (reference write_met_nc,
mptrac.c:13922-14165).

Writes a netCDF3-classic file (via scipy) with the reference's
variable names and unit scalings, readable by both this framework's
reader and the reference.
"""

from __future__ import annotations

import numpy as np
from scipy.io import netcdf_file

from mptrac_tpu_torch.constants import G0
from mptrac_tpu_torch.types import Met

#: (nc name, met 2-D field, scale applied on write)
_SURF = [
    ("sp", "ps", 100.0), ("z", "zs", 1000.0 * G0), ("t2m", "ts", 1.0),
    ("u10m", "us", 1.0), ("v10m", "vs", 1.0), ("iews", "ess", 1.0),
    ("inss", "nss", 1.0), ("ishf", "shf", 1.0), ("lsm", "lsm", 1.0),
    ("sstk", "sst", 1.0), ("blp", "pbl", 100.0), ("pt", "pt", 100.0),
    ("tt", "tt", 1.0), ("zt", "zt", 1000.0), ("h2ot", "h2ot", 1.0),
    ("pct", "pct", 100.0), ("pcb", "pcb", 100.0), ("cl", "cl", 1.0),
    ("plcl", "plcl", 100.0), ("plfc", "plfc", 100.0),
    ("pel", "pel", 100.0), ("cape", "cape", 1.0), ("cin", "cin", 1.0),
    ("o3c", "o3c", 1.0),
]

#: (nc name, met 3-D field, scale); h2o is written back as specific
#: humidity q and o3 as mass mixing ratio (inverse of the read scaling)
_LEV = [
    ("t", "t", 1.0), ("u", "u", 1.0), ("v", "v", 1.0),
    ("w", "w", 100.0), ("q", "h2o", None), ("o3", "o3", None),
    ("clwc", "lwc", 1.0), ("crwc", "rwc", 1.0), ("ciwc", "iwc", 1.0),
    ("cswc", "swc", 1.0), ("cc", "cc", 1.0),
]


def _n(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def write_met_nc(filename: str, met: Met,
                 drop_wrap_column: bool = False) -> None:
    from mptrac_tpu_torch.constants import MA, MH2O, MO3
    nx = met.nx - (1 if drop_wrap_column else 0)
    ny, npl = met.ny, met.npl

    nc = netcdf_file(filename, "w")
    try:
        nc.createDimension("time", 1)
        if met.coord_type == 0:
            nc.createDimension("lon", nx)
            nc.createDimension("lat", ny)
            xname, yname = "lon", "lat"
        else:
            nc.createDimension("x", nx)
            nc.createDimension("y", ny)
            xname, yname = "x", "y"
        nc.createDimension("lev", npl)

        vt = nc.createVariable("time", "d", ("time",))
        vt[:] = np.asarray([float(met.time)])
        vt.units = b"seconds since 2000-01-01 00:00:00 UTC"
        vx = nc.createVariable(xname, "d", (xname,))
        vx[:] = _n(met.lon)[:nx]
        vy = nc.createVariable(yname, "d", (yname,))
        vy[:] = _n(met.lat)
        vl = nc.createVariable("lev", "d", ("lev",))
        vl[:] = _n(met.p) * 100.0
        vl.units = b"Pa"

        for name, field, scale in _SURF:
            v = nc.createVariable(name, "f", ("time", yname, xname))
            data = _n(met.fields2d[field])[:nx].T[None] * scale
            v[:] = data.astype(np.float32)

        for name, field, scale in _LEV:
            if field not in met.fields3d:
                continue
            v = nc.createVariable(name, "f",
                                  ("time", "lev", yname, xname))
            raw = _n(met.fields3d[field])[:nx]
            if scale is None:
                scale = (MH2O / MA) if name == "q" else (MO3 / MA)
            data = raw.transpose(2, 1, 0)[None] * scale
            v[:] = data.astype(np.float32)
    finally:
        nc.close()
