"""netCDF meteo ingest.

Host-side reader producing a :class:`mptrac_tpu_torch.types.Met` snapshot from
reanalysis files, matching the variable aliasing, unit scaling, layout
conversion and missing-data semantics of the reference reader
(mptrac.c: read_met_nc c:11034, read_met_nc_grid
c:9314, read_met_nc_surface c:9501, read_met_nc_levels c:9639,
read_met_nc_2d c:9836, read_met_nc_3d c:10158).

Uses ``scipy.io.netcdf_file`` (netCDF3 classic); values equal to the
``_FillValue``/``missing_value`` attributes or with magnitude >= 1e14
become NaN, exactly like the reference.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
from scipy.io import netcdf_file

from mptrac_tpu_torch.config import Ctl
from mptrac_tpu_torch.constants import G0, MA, MH2O, MO3
from mptrac_tpu_torch.timeutil import time2jsec
from mptrac_tpu_torch.types import MET_2D_FIELDS, MET_3D_FIELDS


def time_from_filename(filename: str, offset: int = 16) -> float:
    """Decode time from ``..._YYYY_MM_DD_HH.nc``-style names
    (reference time_from_filename, c:12383)."""
    base = filename[-offset:]
    year, mon, day, hour = int(base[0:4]), int(base[5:7]), int(
        base[8:10]), int(base[11:13])
    if not (1900 <= year <= 2100 and 1 <= mon <= 12 and 1 <= day <= 31
            and 0 <= hour <= 23):
        raise ValueError(f"Cannot read time from filename: {filename}")
    return time2jsec(year, mon, day, hour)


def time_from_clams_filename(filename: str, century: int = 20) -> float:
    """Decode time from CLaMS ``..._YYMMDDHH.nc`` names (reference
    read_met_nc_grid CLaMS branch, c:9352-9369; the century comes from
    the sign of the file's time variable)."""
    base = filename[-11:-3]
    year = century * 100 + int(base[0:2])
    mon, day, hour = int(base[2:4]), int(base[4:6]), int(base[6:8])
    if not (1900 <= year <= 2100 and 1 <= mon <= 12 and 1 <= day <= 31
            and 0 <= hour <= 23):
        raise ValueError(f"Cannot read time from filename: {filename}")
    return time2jsec(year, mon, day, hour)


def get_met_filename(ctl: Ctl, t: float, direct: int) -> str:
    """Template the meteo filename for time t (reference
    get_met_filename, c:2619): round t down (direct=-1) or up (+1) to
    the met time step and expand YYYY/MM/DD/HH into
    ``<metbase>_YYYY_MM_DD_HH.<ext>``."""
    from mptrac_tpu_torch.timeutil import jsec2time
    import math
    if direct == -1:
        t6 = math.floor(t / ctl.dt_met) * ctl.dt_met
    else:
        t6 = math.ceil(t / ctl.dt_met) * ctl.dt_met
    year, mon, day, hour, _, _, _ = jsec2time(t6)
    if ctl.met_clams:
        return f"{ctl.metbase}_{year % 100:02d}{mon:02d}{day:02d}{hour:02d}.nc"
    ext = {0: "nc", 1: "bin", 2: "pck", 3: "zfp", 4: "zstd", 5: "cms",
           6: "grb", 7: "sz3", 8: "lz4"}.get(ctl.met_type, "nc")
    return f"{ctl.metbase}_{year:04d}_{mon:02d}_{day:02d}_{hour:02d}.{ext}"


def _read_var(nc, names: Sequence[str], scale: float = 1.0,
              log_transform: bool = False) -> Optional[np.ndarray]:
    """Read the first existing variable from an alias list, apply fill
    semantics (reference read_met_nc_2d/3d) and scale."""
    var = None
    for n in names:
        if n and n in nc.variables:
            var = nc.variables[n]
            break
    if var is None:
        return None
    data = np.array(var[:], dtype=np.float64)
    fill = getattr(var, "_FillValue", None)
    miss = getattr(var, "missing_value", None)
    bad = np.abs(data) >= 1e14
    if fill is not None and float(fill) != 0:
        bad |= data == float(fill)
    if miss is not None and float(miss) != 0:
        bad |= data == float(miss)
    # Packed shorts (scale_factor/add_offset) are applied by scipy?  No:
    # scipy.io.netcdf does NOT auto-apply packing; handle explicitly.
    sf = getattr(var, "scale_factor", None)
    ao = getattr(var, "add_offset", None)
    if sf is not None or ao is not None:
        data = data * (float(sf) if sf is not None else 1.0) + (
            float(ao) if ao is not None else 0.0)
        bad |= np.abs(data) >= 1e14
    if log_transform:
        data = np.exp(data)
    data = data * scale
    data[bad] = np.nan
    return data


def _to_xy(data: np.ndarray, convention: int = 0) -> np.ndarray:
    """File layout -> final (lon, lat[, lev]) layout.

    Convention 0 (MPTRAC, reference read_met_nc_3d c:10264): file dims
    (time, [lev,] lat, lon); 2-D (1, ny, nx) -> (nx, ny); 3-D
    (1, nl, ny, nx) -> (nx, ny, nl).  Convention 1 (CLaMS, c:10283):
    file dims (time, lon, lat[, lev]) — already the final ordering.
    """
    data = np.squeeze(data, axis=0) if data.shape[0] == 1 and data.ndim in (
        3, 4) else data
    if convention != 0:
        if data.ndim in (2, 3):
            return np.ascontiguousarray(data).astype(np.float32)
        raise ValueError(f"Unexpected variable rank: {data.shape}")
    if data.ndim == 2:       # (ny, nx)
        return np.ascontiguousarray(data.T).astype(np.float32)
    if data.ndim == 3:       # (nl, ny, nx)
        return np.ascontiguousarray(data.transpose(2, 1, 0)).astype(
            np.float32)
    raise ValueError(f"Unexpected variable rank: {data.shape}")


class _SelVar:
    """Hyperslab view of one netCDF variable: horizontal dims sliced
    by index arrays, attributes passed through."""

    def __init__(self, var, name, xsel, ysel, lon_axis, lat_axis):
        self._var = var
        self._name = name
        self._xsel = xsel
        self._ysel = ysel
        self._lon = lon_axis
        self._lat = lat_axis

    def __getattr__(self, k):
        return getattr(self._var, k)

    def __getitem__(self, key):
        data = self._var.data
        if data.ndim >= 2:
            # layout (time, [lev,] lat, lon): y rows first (reads only
            # the selected records from the mapped file), then x
            return np.asarray(data[..., self._ysel, :][..., self._xsel])
        if self._name in ("lon", "x"):
            return self._lon
        if self._name in ("lat", "y"):
            return self._lat
        return np.asarray(data)


class _HyperslabNC:
    """netCDF handle proxy limiting horizontal reads to a tile
    (reference analog: the per-rank parallel-netCDF hyperslab reads of
    dd_read_met_nc_grid, c:11077-11253)."""

    def __init__(self, nc, xsel, ysel, lon_axis, lat_axis):
        self._nc = nc
        self.variables = {
            name: _SelVar(v, name, xsel, ysel, lon_axis, lat_axis)
            for name, v in nc.variables.items()}

    def close(self):
        try:
            self._nc.close()
        except Exception:
            pass


def read_met_nc(filename: str, ctl: Ctl, sel=None):
    """Read one meteo snapshot from netCDF into host numpy arrays.

    ``sel`` optionally restricts the read to a horizontal hyperslab:
    ``(xidx, yidx, lon_axis, lat_axis)`` index arrays plus the
    replacement axes (monotone across a periodic wrap / pole-clamped
    halos).  With a memory-mapped file only the selected latitude rows
    are read from disk — the domain-decomposition tile path (reference
    dd_read_met_nc_grid, c:11077).

    Returns a dict with grid axes and raw field dicts; the
    preprocessing chain (:mod:`mptrac_tpu_torch.met.process`) turns it into a
    finished :class:`Met`.
    """
    nc = netcdf_file(filename, mmap=sel is not None)
    if sel is not None:
        xidx, yidx, lon_axis, lat_axis = sel
        nc = _HyperslabNC(nc, np.asarray(xidx), np.asarray(yidx),
                          np.asarray(lon_axis, np.float64),
                          np.asarray(lat_axis, np.float64))
    try:
        out: Dict[str, object] = {}
        if ctl.met_clams:
            # CLaMS names carry only YYMMDDHH; the century comes from
            # the sign of the file's time value (reference c:9355).
            # (a file without its time variable is an error, as in the
            # reference's NC_GET_DOUBLE; it is not dated in century 20)
            if "time" not in nc.variables:
                raise ValueError(
                    f"Cannot read the time variable of {filename}: the "
                    "century of a CLaMS file name comes from its sign")
            rtime = float(np.array(
                nc.variables["time"][:], np.float64).ravel()[0])
            out["time"] = time_from_clams_filename(
                filename, 19 if rtime < 0 else 20)
        else:
            out["time"] = time_from_filename(filename)
        conv = ctl.met_convention

        def to_xy(d):
            return _to_xy(d, conv)

        v = nc.variables
        if ctl.met_coord_type == 0:
            lon = np.array(v["lon"][:], np.float64)
            lat = np.array(v["lat"][:], np.float64)
        else:
            lon = np.array(v["x"][:], np.float64)
            lat = np.array(v["y"][:], np.float64)
        out["lon"], out["lat"] = lon, lat
        out["coord_type"] = ctl.met_coord_type

        # Vertical levels: from the vertical dim of u
        # (reference c:9380-9400); level variable in Pa -> hPa.
        for levname in ("lev", "plev", "level", "hybrid", "lev_2"):
            if levname in v:
                break
        p = np.array(v[levname][:], np.float64) / 100.0
        out["p"] = p
        out["hybrid"] = (np.array(v["hybrid"][:], np.float64)
                         if levname == "hybrid" else np.zeros_like(p))

        f2: Dict[str, np.ndarray] = {}
        f3: Dict[str, np.ndarray] = {}

        # --- Surface fields (reference read_met_nc_surface, c:9501) ---
        ps = _read_var(nc, ["lnsp", "LNSP"], 0.01, log_transform=True)
        if ps is None:
            ps = _read_var(nc, ["ps", "PS", "sp", "SP"], 0.01)
        if ps is None:
            # No surface pressure in the file: the lowest level's, built
            # in the final [nx, ny] layout whatever the convention.  On
            # model levels the level axis is an index, not a pressure:
            # then the fill comes from MET_P (the reference warns and
            # uses met_p[0]) and its absence is an error.
            if ctl.met_vert_coord != 0:
                if not ctl.met_p:
                    raise ValueError(
                        f"{filename} has no surface pressure, and on "
                        "model levels none can be taken from the level "
                        "axis: set MET_P")
                fill = float(ctl.met_p[0])
            else:
                fill = float(p[0])
            f2["ps"] = np.full((lon.size, lat.size), fill, np.float32)
        else:
            f2["ps"] = to_xy(ps)

        if ctl.met_clams:
            # CLaMS: surface height = lowest level of the 3-D
            # geopotential (reference read_met_nc_surface, c:9544-9560)
            g = _read_var(nc, ["gph", "GPH"], 1e-3 / G0)
            if g is None:
                raise ValueError(
                    f"Cannot read geopotential height from {filename}")
            f2["zs"] = np.ascontiguousarray(to_xy(g)[..., 0])
        else:
            zs = _read_var(nc, ["z", "Z"], 1.0 / (1000.0 * G0))
            if zs is None:
                zs = _read_var(nc, ["zm", "ZM"],
                               1e-3 / G0 if ctl.met_gp2z else 1e-3)
            f2["zs"] = to_xy(zs) if zs is not None else np.zeros(
                (lon.size, lat.size), np.float32)

        def surf(name, aliases, scale=1.0, default=0.0):
            d = _read_var(nc, aliases, scale)
            f2[name] = (to_xy(d) if d is not None
                        else np.full((lon.size, lat.size), default,
                                     np.float32))

        surf("ts", ["t2m", "T2M", "2t", "2T", "t2", "T2"])
        surf("us", ["u10m", "U10M", "10u", "10U", "u10", "U10"])
        surf("vs", ["v10m", "V10M", "10v", "10V", "v10", "V10"])
        surf("ess", ["iews", "IEWS"])
        surf("nss", ["inss", "INSS"])
        surf("shf", ["ishf", "ISHF"])
        surf("lsm", ["lsm", "LSM"])
        surf("sst", ["sstk", "SSTK", "sst", "SST"])
        if ctl.met_pbl == 0:
            surf("pbl", ["blp", "BLP"], 0.01)
        elif ctl.met_pbl == 1:
            surf("pbl", ["blh", "BLH"], 0.001)
        else:
            f2["pbl"] = np.zeros((lon.size, lat.size), np.float32)
        if ctl.met_cape == 0:
            surf("cape", ["cape", "CAPE"], default=np.nan)
            surf("cin", ["cin", "CIN"], default=np.nan)
        else:
            f2["cape"] = np.full((lon.size, lat.size), np.nan, np.float32)
            f2["cin"] = np.full((lon.size, lat.size), np.nan, np.float32)

        # --- Level fields (reference read_met_nc_levels, c:9639) ---
        def lev(name, aliases, scale=1.0, required=False, default=0.0):
            d = _read_var(nc, aliases, scale)
            if d is None:
                if required:
                    raise ValueError(f"Cannot read {name} from {filename}")
                f3[name] = np.full((lon.size, lat.size, p.size), default,
                                   np.float32)
            else:
                f3[name] = to_xy(d)

        lev("t", ["t", "T", "temp", "TEMP"], required=True)
        lev("u", ["u", "U"], required=True)
        lev("v", ["v", "V"], required=True)
        lev("w", ["w", "W", "omega", "OMEGA"], 0.01)
        if not ctl.met_relhum:
            lev("h2o", ["q", "Q", "sh", "SH"], MA / MH2O)
        else:
            lev("h2o", ["rh", "RH"], 0.01)
            pw_ = f3["h2o"] * _psat_np(f3["t"])
            f3["h2o"] = (pw_ / (p[None, None, :]
                                - (1.0 - MH2O / MA) * pw_)).astype(np.float32)
        lev("o3", ["o3", "O3"], MA / MO3)
        lev("lwc", ["clwc", "CLWC"])
        lev("rwc", ["crwc", "CRWC"])
        lev("iwc", ["ciwc", "CIWC"])
        lev("swc", ["cswc", "CSWC"])
        lev("cc", ["cc", "CC"])
        # Geopotential height on levels: filled by read_met_geopot
        f3["z"] = np.full((lon.size, lat.size, p.size), np.nan, np.float32)
        f3["pv"] = np.zeros((lon.size, lat.size, p.size), np.float32)

        # Model-level (CLaMS/diabatic) fields
        npl_ml = 0
        if ctl.advect_vert_coord == 1:
            lev("zetal", ["ZETA", "zeta"])
            lev("zeta_dotl", ["ZETA_DOT_TOT", "ZETA_DOT_clr",
                              "zeta_dot_clr"], 0.00001157407)
            npl_ml = p.size
        if ctl.met_vert_coord != 0 or ctl.advect_vert_coord in (1, 2, 3):
            f3["ul"] = f3["u"].copy()
            f3["vl"] = f3["v"].copy()
            f3["wl"] = f3["w"].copy()
            npl_ml = p.size
            if ctl.met_vert_coord == 1:
                # Pa-scaled aliases first, then CLaMS "PRESS" already
                # in hPa (reference c:9749-9756)
                d = _read_var(nc, ["pl", "PL", "pressure", "PRESSURE"],
                              0.01)
                if d is None:
                    d = _read_var(nc, ["press", "PRESS"], 1.0)
                if d is None:
                    raise ValueError(
                        f"Cannot read model-level pressure from "
                        f"{filename}")
                f3["pl"] = to_xy(d)
        out["npl_ml"] = npl_ml

        # Remaining 2-D diagnostics are filled by preprocessing
        for name in MET_2D_FIELDS:
            if name not in f2:
                f2[name] = np.full((lon.size, lat.size), np.nan, np.float32)
        for name in MET_3D_FIELDS:
            if name not in f3:
                f3[name] = np.zeros((lon.size, lat.size, p.size), np.float32)

        out["fields2d"] = f2
        out["fields3d"] = f3
        return out
    finally:
        nc.close()


def _psat_np(t):
    return 6.112 * np.exp(17.62 * (t - 273.15) / (243.12 + t - 273.15))
