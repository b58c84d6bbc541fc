"""GRIB meteo ingest (MET_TYPE 6).

Counterpart of the JAX package's ``met/read_grib.py``, a rebuild of the
reference read_met_grib (mptrac.c:10467-10907, optional ECCODES build):
the met base name contains ``XX``, which expands to the ``sf`` (surface)
and ``ml`` (model/pressure level) companion files.  Decoding uses the
pure-Python GRIB reader (``io/grib1``, which hands edition 2 to
``io/grib2``) on the host; fields are identified by ECMWF table-2
parameter codes, matching the variable aliases of the netCDF path
(read_met_nc_surface/levels).  The result goes through the host chain of
``met/build.read_met`` as a netCDF file's does.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from mptrac_tpu_torch.config import Ctl
from mptrac_tpu_torch.constants import G0, MA, MH2O, MO3
from mptrac_tpu_torch.io.grib1 import decode_file
from mptrac_tpu_torch.met.read_nc import time_from_filename
from mptrac_tpu_torch.types import MET_2D_FIELDS, MET_3D_FIELDS

#: ECMWF table-2 code -> (met 2-D field, scale)
SURF_CODES = {
    134: ("ps", 0.01), 152: ("_lnsp", 1.0), 129: ("zs", 1.0 / (1000 * G0)),
    167: ("ts", 1.0), 165: ("us", 1.0), 166: ("vs", 1.0),
    229: ("ess", 1.0), 230: ("nss", 1.0), 231: ("shf", 1.0),
    172: ("lsm", 1.0), 34: ("sst", 1.0), 159: ("_blh", 0.001),
    59: ("cape", 1.0),
}

#: code -> (met 3-D field, scale)
LEVEL_CODES = {
    130: ("t", 1.0), 131: ("u", 1.0), 132: ("v", 1.0),
    135: ("w", 0.01), 133: ("h2o", MA / MH2O), 203: ("o3", MA / MO3),
    246: ("lwc", 1.0), 75: ("rwc", 1.0), 247: ("iwc", 1.0),
    76: ("swc", 1.0), 248: ("cc", 1.0),
}


def read_met_grib(filename: str, ctl: Ctl) -> Dict[str, object]:
    sf_file = filename.replace("XX", "sf")
    ml_file = filename.replace("XX", "ml")
    sf_recs = decode_file(sf_file)
    ml_recs = decode_file(ml_file) if ml_file != sf_file else []

    # Grid from the first record
    r0 = (ml_recs or sf_recs)[0]
    nx, ny = r0.nx, r0.ny
    lon = r0.lon0 + r0.dlon * np.arange(nx)
    lat = np.linspace(r0.lat0, r0.lat1, ny)
    if lat[0] > lat[-1]:
        flip_lat = True
        lat = lat[::-1].copy()
    else:
        flip_lat = False

    def grid_of(rec):
        v = rec.values  # [ny, nx]
        if flip_lat:
            v = v[::-1]
        return np.ascontiguousarray(v.T).astype(np.float32)  # [nx, ny]

    # Vertical levels from isobaric records (level_type 100, hPa)
    levels = sorted({r.level for r in ml_recs if r.level_type == 100},
                    reverse=True)
    p = np.array(levels, np.float64)
    if p.size == 0:
        p = np.array([1000.0, 1.0])
    f2 = {}
    f3 = {name: np.full((nx, ny, p.size), np.nan, np.float32)
          for name, _ in LEVEL_CODES.values()}

    for rec in sf_recs:
        info = SURF_CODES.get(rec.param)
        if info is None:
            continue
        name, scale = info
        f2[name] = grid_of(rec) * scale
    if "_lnsp" in f2 and "ps" not in f2:
        f2["ps"] = (np.exp(f2.pop("_lnsp")) / 100.0).astype(np.float32)
    f2.pop("_lnsp", None)
    if "_blh" in f2 and ctl.met_pbl == 1:
        f2["pbl"] = f2["_blh"]
    f2.pop("_blh", None)

    lev_index = {lev: i for i, lev in enumerate(levels)}
    for rec in ml_recs:
        if rec.level_type != 100:
            continue
        info = LEVEL_CODES.get(rec.param)
        if info is None:
            continue
        name, scale = info
        f3[name][:, :, lev_index[rec.level]] = grid_of(rec) * scale

    for name in MET_2D_FIELDS:
        f2.setdefault(name, np.full((nx, ny), np.nan, np.float32))
    for name in MET_3D_FIELDS:
        f3.setdefault(name, np.zeros((nx, ny, p.size), np.float32))
    f3["z"] = np.full((nx, ny, p.size), np.nan, np.float32)
    f3["pv"] = np.zeros((nx, ny, p.size), np.float32)
    if np.isnan(f3["t"]).all():
        f3["t"][:] = 250.0
        f3["u"][:] = 0.0
        f3["v"][:] = 0.0
        f3["w"][:] = 0.0
    if "ps" not in f2 or np.isnan(f2["ps"]).all():
        f2["ps"] = np.full((nx, ny), float(p[0]), np.float32)

    try:
        time = time_from_filename(filename)
    except Exception:
        r = sf_recs[0]
        from mptrac_tpu_torch.timeutil import time2jsec
        time = time2jsec(r.year, r.mon, r.day, r.hour, r.minute)

    return dict(time=time, lon=lon, lat=lat, p=p,
                hybrid=np.zeros(p.size), fields2d=f2, fields3d=f3,
                coord_type=ctl.met_coord_type, npl_ml=0)
